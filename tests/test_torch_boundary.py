"""The port's package boundary: it imports torch, never JAX or the JAX
package, and its entry points default to the card."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch
from graphlearn_tpu_torch.data import Dataset, Feature, Graph
from graphlearn_tpu_torch.data.cold_cache import (DeviceColdCache,
                                                  MeshColdCache,
                                                  PinnedColdBuffer)
from graphlearn_tpu_torch.loader import FusedTreeEpoch, NeighborLoader
from graphlearn_tpu_torch.models import GraphSAGE, TreeSAGE
from graphlearn_tpu_torch.ops import merge_delta_csr_device
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           DistNeighborSampler,
                                           build_dist_feature,
                                           build_dist_graph,
                                           make_dp_eval_step, make_mesh,
                                           rdma_gather)
from graphlearn_tpu_torch.sampler import NeighborSampler
from graphlearn_tpu_torch.serving import ServingEngine
from graphlearn_tpu_torch.streaming import (DeltaSegment, IngestPipeline,
                                            StreamingGraph)

PKG = Path(graphlearn_tpu_torch.__file__).parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'graphlearn_tpu')


def _forbidden(module: str) -> bool:
  return module.split('.')[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
  code = (
      'import sys\n'
      'before = set(sys.modules)\n'
      'import graphlearn_tpu_torch\n'
      'import graphlearn_tpu_torch.serving.frontend\n'
      'import graphlearn_tpu_torch.serving.router\n'
      'import graphlearn_tpu_torch.serving.autoscaler\n'
      'import graphlearn_tpu_torch.serving.swap\n'
      'import graphlearn_tpu_torch.serving.aot_cache\n'
      'import graphlearn_tpu_torch.telemetry.slo\n'
      'import graphlearn_tpu_torch.distributed.resilience\n'
      'import graphlearn_tpu_torch.streaming\n'
      'import graphlearn_tpu_torch.telemetry.postmortem\n'
      'import graphlearn_tpu_torch.testing.chaos\n'
      'import graphlearn_tpu_torch.utils.checkpoint\n'
      'import graphlearn_tpu_torch.parallel\n'
      'import graphlearn_tpu_torch.parallel.rdma_gather\n'
      'import graphlearn_tpu_torch.parallel.failover\n'
      'import graphlearn_tpu_torch.parallel.handoff\n'
      'import graphlearn_tpu_torch.data.cold_cache\n'
      'import graphlearn_tpu_torch.data.reorder\n'
      'import graphlearn_tpu_torch.ops.cold_gather\n'
      'import graphlearn_tpu_torch.loader.prefetch\n'
      'import graphlearn_tpu_torch.sampler\n'
      'new = sorted(set(sys.modules) - before)\n'
      'bad = [m for m in new if m.split(".")[0] in '
      f'{FORBIDDEN!r}]\n'
      'print("BAD", bad)\n'
      'assert "graphlearn_tpu_torch.serving.engine" in sys.modules\n'
      'assert "graphlearn_tpu_torch.streaming.ingest" in sys.modules\n'
      'assert "graphlearn_tpu_torch.telemetry.live" in sys.modules\n'
      'assert "graphlearn_tpu_torch.parallel.dist_sampler" in sys.modules\n'
      'assert "graphlearn_tpu_torch.parallel.rdma_gather" in sys.modules\n'
      'assert "graphlearn_tpu_torch.parallel.partition_book" in '
      'sys.modules\n'
      'assert "graphlearn_tpu_torch.parallel.handoff" in sys.modules\n'
      'assert "graphlearn_tpu_torch.ops.gns" in sys.modules\n'
      'assert "graphlearn_tpu_torch.models.basic_gnn" in sys.modules\n'
      'assert "graphlearn_tpu_torch.sampler.neighbor_sampler" in '
      'sys.modules\n'
      'assert "graphlearn_tpu_torch.loader.neighbor_loader" in sys.modules\n'
      'assert "graphlearn_tpu_torch.loader.fused" in sys.modules\n'
      'assert "graphlearn_tpu_torch.ops.window_gather" in sys.modules\n'
      'assert "graphlearn_tpu_torch.ops.cold_gather" in sys.modules\n'
      'assert "graphlearn_tpu_torch.loader.prefetch" in sys.modules\n'
      'assert "graphlearn_tpu_torch.data.reorder" in sys.modules\n')
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=str(PKG.parent), timeout=240)
  assert out.returncode == 0, out.stderr
  assert 'BAD []' in out.stdout, out.stdout


def test_no_forbidden_import_in_sources():
  files = sorted(PKG.rglob('*.py'))
  assert len(files) > 10
  for path in files:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module or '']
      else:
        continue
      bad = [n for n in names if _forbidden(n)]
      assert not bad, f'{path.relative_to(PKG)} imports {bad}'


def test_every_knob_the_port_reads_is_documented():
  """Knob hygiene: every ``GLT_*`` name in the port's sources is one the
  JAX package documents in ``benchmarks/README.md``."""
  import re
  doc = (PKG.parent / 'benchmarks' / 'README.md').read_text()
  knobs = set()
  for path in PKG.rglob('*.py'):
    knobs.update(re.findall(r'[\'"](GLT_[A-Z0-9_]+)[\'"]',
                            path.read_text()))
  assert {'GLT_SHARD_DIR', 'GLT_ADOPT_TIMEOUT_S',
          'GLT_DEGRADED_OK', 'GLT_PARTITIONER', 'GLT_LOCALITY_EPS',
          'GLT_LOCALITY_PASSES', 'GLT_LOCALITY_REPLICA_FRAC',
          'GLT_REBALANCE_OVERLOAD', 'GLT_EXCHANGE_LAYOUT',
          'GLT_EXCHANGE_POOL_FRAC', 'GLT_EXCHANGE_EWMA',
          'GLT_EXCHANGE_EWMA_ALPHA', 'GLT_EXCHANGE_EWMA_HEADROOM'} <= knobs
  assert sorted(k for k in knobs if k not in doc) == []


@pytest.mark.parametrize('script', ['chip_smoke.py'])
def test_card_scripts_import_no_jax(script):
  """The scripts that drive the port on the card import neither JAX nor
  the JAX package, at any depth of their code."""
  path = PKG.parent / script
  tree = ast.parse(path.read_text(), filename=str(path))
  seen = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      seen += [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      seen.append(node.module or '')
  assert 'graphlearn_tpu_torch' in {n.split('.')[0] for n in seen}
  bad = [n for n in seen if _forbidden(n)]
  assert not bad, f'{script} imports {bad}'


def test_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  feats = np.zeros((4, 2), np.float32)
  coo = (np.array([0, 1]), np.array([1, 2]))
  with pytest.raises(RuntimeError, match='CUDA'):
    Dataset().init_graph(coo)
  with pytest.raises(RuntimeError, match='CUDA'):
    Dataset().init_node_features(feats)
  with pytest.raises(RuntimeError, match='CUDA'):
    Feature(feats)
  with pytest.raises(RuntimeError, match='CUDA'):
    Feature(feats, split_ratio=0.5)
  with pytest.raises(RuntimeError, match='CUDA'):
    DeviceColdCache(4, 2, torch.float32)
  with pytest.raises(RuntimeError, match='CUDA'):
    PinnedColdBuffer(feats, 2)
  # asked for: the CPU tiers run the kernels' plain versions
  tiered = Feature(feats, split_ratio=0.5, device='cpu')
  assert tiered.get(np.array([0, 3])).device.type == 'cpu'
  ds = (Dataset().init_graph(coo, num_nodes=4, device='cpu')
        .init_node_features(feats, device='cpu'))
  with pytest.raises(RuntimeError, match='CUDA'):
    Graph(ds.get_graph().csr_topo)
  with pytest.raises(RuntimeError, match='CUDA'):
    ServingEngine(ds, [2])
  ServingEngine(ds, [2], device='cpu')     # asked for: runs on the CPU


def test_training_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  coo = (np.array([0, 1, 2]), np.array([1, 2, 0]))
  ds = (Dataset().init_graph(coo, num_nodes=4, device='cpu')
        .init_node_features(np.zeros((4, 2), np.float32), device='cpu')
        .init_node_labels(np.zeros(4, np.int32)))
  model = TreeSAGE(2, 4, 3, num_layers=1)
  opt = torch.optim.Adam(model.parameters())
  with pytest.raises(RuntimeError, match='CUDA'):
    NeighborSampler(ds.get_graph(), [2])
  with pytest.raises(RuntimeError, match='CUDA'):
    NeighborLoader(ds, [2], np.arange(4), batch_size=2)
  with pytest.raises(RuntimeError, match='CUDA'):
    FusedTreeEpoch(ds, [2], np.arange(4), model, opt, 2)
  # asked for: the CPU runs the kernels' plain versions
  b = next(iter(NeighborLoader(ds, [2], np.arange(4), batch_size=2,
                               device='cpu')))
  assert b.x.device.type == 'cpu' and b.y.device.type == 'cpu'
  assert FusedTreeEpoch(ds, [2], np.arange(4), model, opt, 2,
                        device='cpu').run().losses.shape == (2,)


def test_streaming_entry_points_default_to_cuda(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  rows, cols = np.array([0, 1, 2]), np.array([1, 2, 0])
  indptr, indices = np.array([0, 1, 2, 3]), np.array([1, 2, 0])
  with pytest.raises(RuntimeError, match='CUDA'):
    StreamingGraph(indptr, indices)
  with pytest.raises(RuntimeError, match='CUDA'):
    StreamingGraph.from_coo(rows, cols, num_nodes=3)
  with pytest.raises(RuntimeError, match='CUDA'):
    IngestPipeline(StreamingGraph.from_coo(rows, cols), wal_dir=tmp_path)
  seg = DeltaSegment(src=np.array([0]), dst=np.array([2]),
                     eids=np.array([3]))
  with pytest.raises(RuntimeError, match='CUDA'):
    merge_delta_csr_device(indptr, indices, np.arange(3), seg)
  # asked for: the CPU runs the kernel's plain version
  sg = StreamingGraph(indptr, indices, device='cpu')
  pipe = IngestPipeline(sg, wal_dir=str(tmp_path))
  pipe.ingest([0], [2])
  assert sg.version == 2 and sg.pin().indices_dev.device.type == 'cpu'
  pipe.close()


def test_mesh_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  n = 40
  rows, cols = np.repeat(np.arange(n), 3), np.arange(3 * n) % n
  feats = np.zeros((n, 2), np.float32)
  with pytest.raises(RuntimeError, match='CUDA'):
    make_mesh(1)
  with pytest.raises(RuntimeError, match='CUDA'):
    make_mesh(8)
  with pytest.raises(RuntimeError, match='CUDA'):
    DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                split_ratio=0.3)
  with pytest.raises(RuntimeError, match='CUDA'):
    MeshColdCache(4, 2, torch.float32)
  ds = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                   split_ratio=0.3, device='cpu')
  with pytest.raises(RuntimeError, match='CUDA'):
    DistNeighborLoader(ds, [2], np.arange(n), batch_size=4)
  with pytest.raises(RuntimeError, match='CUDA'):
    DistNeighborSampler(ds, [2])
  with pytest.raises(RuntimeError, match='CUDA'):
    build_dist_graph(rows, cols, np.zeros(n, np.int32), n)
  with pytest.raises(RuntimeError, match='CUDA'):
    build_dist_feature(feats, ds.old2new, ds.graph.bounds)
  with pytest.raises(RuntimeError, match='CUDA'):
    DistDataset(ds.graph, ds.node_features, old2new=ds.old2new)
  assert build_dist_graph(rows, cols, np.zeros(n, np.int32), n,
                          device='cpu')[0].indptr.device.type == 'cpu'
  assert DistDataset(ds.graph, device='cpu').device.type == 'cpu'
  # asked for: the CPU runs the kernels' plain versions
  loader = DistNeighborLoader(ds, [2], np.arange(n), batch_size=4,
                              gns=True, device='cpu')
  b = next(iter(loader))
  assert b.x.device.type == 'cpu' and 'edge_weight' in b.metadata
  assert make_mesh(1, device='cpu').device.type == 'cpu'
  # a mesh of 4 partitions on the CPU, asked for: the plain versions
  ds4 = DistDataset.from_full_graph(4, rows, cols, node_feat=feats,
                                    node_label=np.arange(n) % 3,
                                    device='cpu')
  mesh = make_mesh(4, device='cpu')
  assert mesh.size == 4 and mesh.device.type == 'cpu'
  ids = torch.tensor([[0, 5, -1], [7, 39, 2], [1, 1, 1], [-1, 3, 30]])
  got = rdma_gather(mesh, ds4.node_labels, ds4.graph.bounds, ids)
  assert got.device.type == 'cpu' and got.shape == (4, 3)
  b4 = next(iter(DistNeighborLoader(ds4, [2], np.arange(n), batch_size=4,
                                    device='cpu')))
  correct, total = make_dp_eval_step(GraphSAGE(2, 4, 3, num_layers=1), 4,
                                     mesh)(b4)
  assert int(total) == 16 and 0 <= int(correct) <= 16
  assert MeshColdCache(4, 2, torch.float32, device='cpu').rows.shape == (
      1, 4, 2)
