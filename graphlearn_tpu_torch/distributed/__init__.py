"""Process-based host runtime: producers, channels, server-client (the
JAX package's `distributed/`, its single-server planes).

The mesh engine lives in :mod:`graphlearn_tpu_torch.parallel` (sampling
on the card).  This package is the host-side complement — the
reference's `python/distributed/` world: sampling subprocess pools on
the CPU (`MpSamplingProducer` over the native host library) feeding the
trainer on the card through shm channels, and a server-client mode
where sampling servers feed remote trainers over the socket RPC, whose
servers also answer online inference (`DistServer.serve_infer`) for the
fleet router's `RemoteReplica`.

Still to port (slice 25): the partitioned plane — offline partitioning
(`DistRandomPartitioner`, `DistTableRandomPartitioner`), the
cross-server sampler (`HostDistNeighborSampler`, `PartitionService`,
`connect_peers`) and the `from_partition_dir` loaders.
"""
from .dist_client import (DistClient, get_client, init_client,
                          shutdown_client)
from .dist_context import (DistContext, DistRole, get_context,
                           init_worker_group)
from .dist_loader import (DistLinkNeighborLoader, DistLoader,
                          DistNeighborLoader, DistSubGraphLoader)
from .dist_options import (CollocatedDistSamplingWorkerOptions,
                           HostSamplingConfig,
                           MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import (CollocatedSamplingProducer,
                                     MpSamplingProducer)
from .dist_server import (DistServer, get_server, init_server,
                          wait_and_shutdown_server)
from .resilience import (FailoverExhausted, PeerLostError,
                         ReplayEvictedError, ReplicaLostError,
                         RetryExhausted, RetryPolicy, degraded_ok)
from .rpc import RpcError
from .host_dataset import HostDataset, HostHeteroDataset
from .host_sampler import HostHeteroNeighborSampler, HostNeighborSampler
from .shm_arrays import SharedDatasetHandle, share_dataset

__all__ = [
    'DistContext', 'DistRole', 'get_context', 'init_worker_group',
    'DistLoader', 'DistNeighborLoader', 'DistLinkNeighborLoader',
    'DistSubGraphLoader', 'HostSamplingConfig',
    'CollocatedDistSamplingWorkerOptions', 'MpDistSamplingWorkerOptions',
    'RemoteDistSamplingWorkerOptions',
    'CollocatedSamplingProducer', 'MpSamplingProducer',
    'DistServer', 'get_server', 'init_server', 'wait_and_shutdown_server',
    'DistClient', 'get_client', 'init_client', 'shutdown_client',
    'HostDataset', 'HostHeteroDataset', 'HostNeighborSampler',
    'HostHeteroNeighborSampler', 'SharedDatasetHandle', 'share_dataset',
    'RetryPolicy', 'RetryExhausted', 'PeerLostError', 'ReplayEvictedError',
    'ReplicaLostError', 'FailoverExhausted', 'RpcError', 'degraded_ok',
]
