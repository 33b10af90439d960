"""Sample-message channels: producer -> consumer transport (the JAX
package's `channel/`): typed queues carrying flat ``SampleMessage``
dicts of numpy arrays from sampling producers to the training process.
"""
from .base import ChannelBase, ChannelTelemetry, SampleMessage
from .mp_channel import MpChannel
from .remote_channel import RemoteReceivingChannel
from .shm_channel import ShmChannel

__all__ = ['ChannelBase', 'ChannelTelemetry', 'SampleMessage', 'ShmChannel',
           'MpChannel', 'RemoteReceivingChannel']
