"""graphlearn_tpu_torch: the PyTorch + CUDA (Hopper) port of
graphlearn_tpu.

This package imports torch and never JAX, nor anything of the JAX
package.  Its entry points run on the card (``device='cuda'``) unless
the caller asks for the CPU, and raise when CUDA is missing.  Kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` on first use; on
CUDA tensors a kernel wrapper launches its kernel or raises, and only
tensors on the CPU take the plain PyTorch version.

Ported so far: the online serving path — `data.Dataset` (CSR graph +
device feature table), `loader.expand_tree_levels` over the one-hop
sampler kernel, the fused row-gather kernel, `models.TreeSAGE`, and
`serving.ServingEngine` / `ServingFrontend` — and serving during live
edge ingest: `streaming.IngestPipeline` (WAL, delta-CSR merge through
the merge-rank kernel, RCU-published `GraphView`s) with the engine
re-pinning the newest version per dispatch; `telemetry` and `testing`
hold the parts of the JAX package's telemetry and chaos harness that
this path calls — and GNS-biased GraphSAGE training over the tiered
mesh feature store: `parallel.DistDataset` (relabelled range shards, hot
rows on the card, cold rows in pinned host memory),
`parallel.DistNeighborLoader` (bucketed exchange, the GNS sampler
kernel, the victim cache `data.cold_cache.MeshColdCache`, the cold
overlay) and `parallel.make_dp_supervised_step` with
`models.GraphSAGE`, on a one-card mesh — and single-card training:
`loader.NeighborLoader` (`sampler.NeighborSampler` over the uniform
sampler kernel and the inducer, collation through the row-gather
kernel) with `models.make_supervised_step` / `make_eval_step`, the
tree-layout `loader.FusedTreeEpoch` with `models.TreeSAGE`, and the CSR
window gather kernel `ops.csr_window_gather` — and heterogeneous graphs
on one card: `data.Dataset` over edge-type dicts,
`sampler.HeteroNeighborSampler`, `loader.NeighborLoader` yielding
`loader.HeteroBatch`es, `models.RGCN` / `models.HGT` and
`loader.FusedHeteroEpoch` — and the host runtime's single-server
planes: the native host library (`native`, built with ``c++``), the
shm / mp / remote `channel`s, and `distributed` (the sampling producers,
`DistNeighborLoader` and its link and subgraph twins collating onto the
card, the socket RPC with its retry and replay cache, `DistServer` /
`DistClient` with the serve RPC behind `serving.RemoteReplica`).
"""
from . import (channel, data, distributed, loader, models, native, ops,
               parallel, sampler, serving, streaming, telemetry, testing,
               utils)

__version__ = '0.1.0'
