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
from graphlearn_tpu_torch.serving import ServingEngine

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
      'new = sorted(set(sys.modules) - before)\n'
      'bad = [m for m in new if m.split(".")[0] in '
      f'{FORBIDDEN!r}]\n'
      'print("BAD", bad)\n'
      'assert "graphlearn_tpu_torch.serving.engine" in sys.modules\n')
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
  ds = (Dataset().init_graph(coo, num_nodes=4, device='cpu')
        .init_node_features(feats, device='cpu'))
  with pytest.raises(RuntimeError, match='CUDA'):
    Graph(ds.get_graph().csr_topo)
  with pytest.raises(RuntimeError, match='CUDA'):
    ServingEngine(ds, [2])
  ServingEngine(ds, [2], device='cpu')     # asked for: runs on the CPU
