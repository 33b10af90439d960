"""The host runtime's typed errors that the serving fleet raises
(`resilience.ReplicaLostError`, `resilience.FailoverExhausted`).  The
runtime itself (rpc, producers, server/client) is ROADMAP item 11."""
from .resilience import FailoverExhausted, ReplicaLostError

__all__ = ['FailoverExhausted', 'ReplicaLostError']
