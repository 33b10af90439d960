#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py            # what the checks below need
    python3 chip_smoke.py --profile  # adds a torch.profiler phase

Phases, one JSON line each; any failure exits nonzero:

  env     card (``nvidia-smi`` name and power limit), torch and CUDA
          versions; TF32 matmuls off.
  build   both CUDA kernels compiled from ``graphlearn_tpu_torch/csrc``
          (one ``nvcc`` per source, started together).
  graph   the ogbn-products-scale synthetic graph (2,449,029 nodes,
          average degree 25, 0.3 hub mixture — the recipe of
          ``benchmarks/common.py``), CSR-sorted on the card from a seed,
          and a ``[N, 100]`` f32 feature table.
  kernel  each kernel against its plain PyTorch version on the card at
          the shapes the serving path gives it (byte-equal required):
          the sampler at every hop of a 16-seed bucket with fanouts
          [15, 10, 5] plus row sets forced through each arm, the row
          gather over a 16-seed tree in f32 and bf16.  Times are the
          device time of one call by CUDA events (the host's enqueue
          hidden behind a busy card), median of 30, with the L2 cache
          flushed before each call; `torch.index_select` is the
          one-call yardstick for the gather.
  serve   `ServingEngine` with ``TreeSAGE(100, 256, 47, 3)`` behind a
          running `ServingFrontend`; 256 requests of 1-16 seeds from 4
          client threads; every future must resolve, launch counts must
          show the kernels (never the plain versions) served; 16
          requests held against `offline_reference`; a small graph
          served on the card and on the CPU must agree.

It prints the ``{"kernels": [...]}`` line before the last and ends with
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
``graphlearn_tpu_torch`` package beside it, it exits nonzero and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

NUM_NODES = 2_449_029               # ogbn-products node count
AVG_DEG = 25
DEVICE = 'cuda'
FEAT_DIM = 100
FANOUTS = (15, 10, 5)
BUCKETS = (1, 2, 4, 8, 16)
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
REPS = 30
N_REQUESTS = 256
N_CLIENTS = 4


def emit(phase: str, **fields) -> None:
  print(json.dumps({'phase': phase, **fields}), flush=True)


def products_graph(torch, device, seed=0):
  """The `benchmarks/common.py` recipe on the card: uniform sources,
  targets uniform or (30%) squared-uniform hubs; CSR sorted by
  (row, col)."""
  n, e = NUM_NODES, NUM_NODES * AVG_DEG
  g = torch.Generator(device=device).manual_seed(seed)
  rows = torch.randint(0, n, (e,), generator=g, device=device)
  hub = torch.rand(e, generator=g, device=device) < 0.3
  u = torch.rand(e, generator=g, device=device)
  cols = torch.where(hub, (u * u * n).long(), (u * n).long())
  del hub, u
  key = torch.sort(rows * n + cols).values
  del cols
  indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
  indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
  indices = (key % n).to(torch.int32)
  return indptr, indices


def arm_graph(torch, device, k, w, rows=4096, seed=1):
  """A CSR whose rows cycle through every sampler arm: empty, take-all
  (1..k), window (k+1..w) and beyond-window hubs (w+1..4w)."""
  rng = np.random.default_rng(seed + k)
  kind = np.arange(rows) % 4
  deg = np.where(kind == 0, 0, np.where(
      kind == 1, rng.integers(1, k + 1, rows), np.where(
          kind == 2, rng.integers(k + 1, w + 1, rows),
          rng.integers(w + 1, 4 * w + 1, rows))))
  indptr = np.zeros(rows + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = rng.integers(0, rows, int(indptr[-1])).astype(np.int32)
  seeds = rng.permutation(rows).astype(np.int32)
  seeds[::97] = -1
  return (torch.from_numpy(indptr).to(device),
          torch.from_numpy(indices).to(device),
          torch.from_numpy(seeds).to(device))


class Timer:
  """Device time of one call by CUDA events, median over `REPS` warm
  calls.  Before each call a 128 MiB buffer is rewritten, so the 50 MB
  L2 starts cold as it does for a serving dispatch's scattered reads,
  and the card is kept busy for a few milliseconds (`torch.cuda._sleep`)
  while the host enqueues the events and the call: the events then
  time the device work, not the Python wrapper's launch overhead
  (that overhead shows in the serve phase's latencies)."""

  SLEEP_CYCLES = 5_000_000          # ~3 ms at the H100's SM clock

  def __init__(self, torch):
    self.torch = torch
    self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)

  def __call__(self, fn) -> float:
    torch = self.torch
    for _ in range(3):
      fn()
    times = []
    for _ in range(REPS):
      self.flush.zero_()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      torch.cuda._sleep(self.SLEEP_CYCLES)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
    return float(np.median(times))


def sample_bytes(deg: np.ndarray, k: int, w: int) -> int:
  """Bytes the sampler must move for these rows, by arm: the seed and
  its two indptr entries, the draws its arm reads (a Gumbel per window
  entry in degree, or k uniforms), the neighbor ids it returns, and the
  ``[k]`` int32 + bool outputs."""
  deg = deg.astype(np.int64)
  take = np.clip(deg, 0, k)
  draws = np.where((deg > k) & (deg <= w), deg, np.where(deg > w, k, 0))
  per_row = 4 + 16 * (deg >= 0) + 4 * draws + 4 * take + 5 * k
  return int(per_row.sum())


def sync(torch) -> None:
  if DEVICE == 'cuda':
    torch.cuda.synchronize()


def check_sampler(torch, ops, timer, indptr, indices, seeds, k, u, g):
  before = ops.sample_one_hop_fused.launches
  got = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g)
  ref = ops.sample_one_hop(indptr, indices, seeds, k, u, g)
  sync(torch)
  if not (torch.equal(got.nbrs, ref.nbrs) and torch.equal(got.mask,
                                                          ref.mask)):
    bad = int((got.nbrs != ref.nbrs).sum())
    raise AssertionError(f'sampler kernel != plain version (k={k}, '
                         f'{bad} slots differ)')
  err = int((got.nbrs.long() - ref.nbrs.long()).abs().max())
  deg = ops.lookup_degree(indptr, seeds).cpu().numpy()
  deg = np.where(seeds.cpu().numpy() >= 0, deg, -1)
  w = g.shape[1]
  nbytes = sample_bytes(deg, k, w)
  rec = {
      'rows': int(seeds.numel()), 'k': k, 'w': w,
      'arms': {'empty_or_invalid': int((deg <= 0).sum()),
               'take_all': int(((deg > 0) & (deg <= k)).sum()),
               'window': int(((deg > k) & (deg <= w)).sum()),
               'hub': int((deg > w).sum())},
      'byte_equal': True, 'max_abs_err': err,
      'kernel_ms': timer(lambda: ops.sample_one_hop_fused(
          indptr, indices, seeds, k, u, g)),
      'plain_ms': timer(lambda: ops.sample_one_hop(
          indptr, indices, seeds, k, u, g)),
      'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  rec['launches'] = ops.sample_one_hop_fused.launches - before
  return got, rec


def check_gather(torch, ops, timer, table, ids):
  before = ops.gather_rows.launches
  got = ops.gather_rows(table, ids)
  ref = ops.gather_rows_plain(table, ids)
  sync(torch)
  if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
    raise AssertionError(f'gather kernel != plain version ({table.dtype})')
  err = float((got.float() - ref.float()).abs().max())
  safe = ids.clamp(min=0).long()
  n_valid = int((ids >= 0).sum())
  row = table.shape[1] * table.element_size()
  nbytes = ids.numel() * ids.element_size() + n_valid * row \
      + ids.numel() * row
  rec = {'ids': int(ids.numel()), 'valid': n_valid,
         'dtype': str(table.dtype).replace('torch.', ''),
         'row_bytes': row, 'byte_equal': True, 'max_abs_err': err,
         'kernel_ms': timer(lambda: ops.gather_rows(table, ids)),
         'plain_ms': timer(lambda: ops.gather_rows_plain(table, ids)),
         'library_ms': timer(lambda: torch.index_select(table, 0, safe)),
         'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  rec['launches'] = ops.gather_rows.launches - before
  return rec


def serve(torch, ds):
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import (gather_rows, gather_rows_plain,
                                        sample_one_hop,
                                        sample_one_hop_fused)
  from graphlearn_tpu_torch.serving import ServingEngine, ServingFrontend
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  warm = eng.warmup()
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  rng = np.random.default_rng(0)
  reqs = [rng.integers(0, NUM_NODES, int(rng.integers(1, 17)))
          for _ in range(N_REQUESTS)]
  results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []

  def client(lo):
    for i in range(lo, len(reqs), N_CLIENTS):
      t0 = time.perf_counter()
      try:
        results[i] = fe.submit(reqs[i]).result(60.0)
      except Exception as e:       # noqa: BLE001 — counted, then fatal
        errors.append(f'request {i}: {type(e).__name__}: {e}')
      lat[i] = (time.perf_counter() - t0) * 1e3

  for fn in (sample_one_hop_fused, gather_rows):
    fn.launches = 0
  for fn in (sample_one_hop, gather_rows_plain):
    fn.calls = 0
  threads = [threading.Thread(target=client, args=(i,))
             for i in range(N_CLIENTS)]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  wall = time.perf_counter() - t0
  launches = {'sample_one_hop': sample_one_hop_fused.launches,
              'gather_rows': gather_rows.launches}
  plain_calls = sample_one_hop.calls + gather_rows_plain.calls
  fe.shutdown()
  stats = fe.stats()
  if errors or stats['failed'] or any(r is None for r in results):
    raise AssertionError(f'serving failed: {errors[:3]} stats={stats}')
  d = stats['dispatches']
  if not (launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] >= d > 0 and plain_calls == 0):
    raise AssertionError(f'launch counts {launches}, plain calls '
                         f'{plain_calls}, dispatches {d}')
  for i, res in enumerate(results):
    n = len(reqs[i])
    if (res.nodes.shape != (n, eng.tree_width)
        or res.logits.shape != (n, 47)
        or not np.isfinite(res.logits).all()):
      raise AssertionError(f'request {i}: bad result shapes/values')
  worst = 0.0
  for i in range(16):
    ref = eng.offline_reference(reqs[i])
    if ref.nodes.tobytes() != results[i].nodes.tobytes():
      raise AssertionError(f'request {i}: nodes differ from offline')
    np.testing.assert_allclose(results[i].logits, ref.logits, rtol=1e-5,
                               atol=1e-5)
    worst = max(worst, float(np.abs(results[i].logits - ref.logits).max()))
  emit('serve', requests=len(reqs), clients=N_CLIENTS,
       seeds=int(sum(len(r) for r in reqs)), dispatches=d,
       failed=stats['failed'], shed=stats['shed'],
       warmup_secs=warm['secs'], wall_secs=wall,
       requests_per_s=len(reqs) / wall,
       latency_ms={'p50': float(np.percentile(lat, 50)),
                   'p99': float(np.percentile(lat, 99)),
                   'max': float(np.max(lat))},
       launches=launches, plain_calls=plain_calls,
       offline_checked=16, offline_logits_max_abs_diff=worst)
  return eng, launches


def small_cross_check(torch):
  """A small graph served on the card (kernels) and on the CPU (plain
  versions) with the same CPU-made draws: nodes byte-equal, logits
  within 1e-5."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import hash_draws
  from graphlearn_tpu_torch.serving import ServingEngine
  rng = np.random.default_rng(5)
  n = 3000
  rows = rng.integers(0, n, n * 20)
  rows = np.concatenate([rows, np.full(300, 7)])      # one hub row
  cols = rng.integers(0, n, rows.shape[0])
  feats = rng.standard_normal((n, 16)).astype(np.float32)

  def cpu_draws(seed_ids, t, f, k, w):
    u, g = hash_draws(3, seed_ids.cpu(), t, f, k, w)
    return u.to(seed_ids.device), g.to(seed_ids.device)

  out = {}
  seeds = np.array([7, 1, 2, 3, 999, 2999, 15], np.int64)
  for dev in (DEVICE, 'cpu'):
    ds = (Dataset().init_graph((rows, cols), num_nodes=n, device=dev)
          .init_node_features(feats, device=dev))
    eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(16, 32, 7, 3),
                        seed=3, buckets=(8,), device=dev, draws=cpu_draws)
    eng.init_params(torch.Generator().manual_seed(1))
    out[dev] = eng.infer(seeds)
  card, cpu = out[DEVICE], out['cpu']
  if card.nodes.tobytes() != cpu.nodes.tobytes():
    raise AssertionError('card and CPU trees differ on the small graph')
  np.testing.assert_allclose(card.logits, cpu.logits, rtol=1e-5, atol=1e-5)
  emit('cross_check', nodes_byte_equal=True,
       logits_max_abs_diff=float(np.abs(card.logits - cpu.logits).max()))


def profile(torch, eng):
  """Device time by kernel over 20 warm 16-seed dispatches (kernel
  events only, so a torch op and the kernel it launched are not both
  counted), grouped into the port's kernels, matmuls, copies and the
  rest (mostly the elementwise ops of the draws and the model)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  n = 20
  seeds = np.random.default_rng(9).integers(0, NUM_NODES, 16)
  for _ in range(3):
    eng.infer(seeds)
  sync(torch)
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(n):
      eng.infer(seeds + i)
    sync(torch)
    wall_ms = (time.perf_counter() - t0) * 1e3
  groups = {'sample_one_hop_kernel': 0.0, 'gather_rows_kernel': 0.0,
            'matmul': 0.0, 'memcpy': 0.0, 'other': 0.0}
  launches = dict.fromkeys(groups, 0)
  top = []
  for ev in prof.key_averages():
    if ev.device_type != DeviceType.CUDA:
      continue
    us = ev.self_device_time_total
    name = ev.key
    group = next((g for g in ('sample_one_hop_kernel', 'gather_rows_kernel')
                  if g in name), None)
    if group is None:
      low = name.lower()
      group = ('matmul' if 'gemm' in low or 'xmma' in low else
               'memcpy' if 'memcpy' in low else 'other')
    groups[group] += us / 1e3
    launches[group] += ev.count
    top.append((us, name, ev.count))
  top.sort(reverse=True)
  busy_ms = sum(groups.values())
  emit('profile', dispatches=n, seeds_per_dispatch=16, wall_ms=wall_ms,
       device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
       device_ms_by_group=groups, launches_by_group=launches,
       device_us_per_launch={
           g: groups[g] * 1e3 / launches[g]
           for g in ('sample_one_hop_kernel', 'gather_rows_kernel')
           if launches[g]},
       top=[{'name': k[:70], 'device_ms': us / 1e3, 'count': c}
            for us, k, c in top[:10]])


def main(argv) -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 2
  root = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, root)
  try:
    import graphlearn_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f'chip_smoke: the graphlearn_tpu_torch package is not beside '
          f'this script ({e})', file=sys.stderr)
    return 2

  # -- env --------------------------------------------------------------
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  name = torch.cuda.get_device_name(0)
  print(smi, flush=True)
  emit('env', nvidia_smi=smi, device=name,
       device_count=torch.cuda.device_count(), torch=torch.__version__,
       cuda=torch.version.cuda, python=sys.version.split()[0],
       matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
       cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
  kernels = run(torch, argv)
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


def run(torch, argv) -> list:
  """The build, graph, kernel and serve phases; returns the
  ``kernels`` summary."""
  from graphlearn_tpu_torch import _build, ops
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.ops import default_window, hash_draws

  # -- build ------------------------------------------------------------
  t0 = time.perf_counter()
  info = _build.build_all()
  emit('build', wall_secs=time.perf_counter() - t0,
       kernels={k: {'secs': v['secs'],
                    'ptxas': [ln.strip() for ln in v['ptxas'].splitlines()
                              if 'registers' in ln or 'spill' in ln]}
                for k, v in info.items()})

  # -- graph ------------------------------------------------------------
  t0 = time.perf_counter()
  indptr, indices = products_graph(torch, DEVICE)
  feats = torch.randn(NUM_NODES, FEAT_DIM, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(1))
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE))
  sync(torch)
  deg = indptr[1:] - indptr[:-1]
  emit('graph', nodes=NUM_NODES, edges=int(indices.numel()),
       max_degree=int(deg.max()), mean_degree=float(deg.float().mean()),
       feature_shape=list(feats.shape), secs=time.perf_counter() - t0,
       bytes={'csr': indptr.numel() * 8 + indices.numel() * 4,
              'features': feats.numel() * 4})

  # -- kernel vs plain --------------------------------------------------
  timer = Timer(torch)
  seeds16 = torch.from_numpy(np.random.default_rng(2).integers(
      0, NUM_NODES, 16).astype(np.int32)).to(DEVICE)
  frontier, levels, hops = seeds16, [seeds16], []
  width = 1
  for t, k in enumerate(FANOUTS):
    w = default_window(k)
    u, g = hash_draws(0, seeds16, t, width, k, w)
    res, rec = check_sampler(torch, ops, timer, indptr, indices, frontier,
                             k, u, g)
    emit('kernel', kernel='sample_one_hop', shape=f'hop {t}', **rec)
    hops.append(rec)
    frontier = res.nbrs.reshape(-1)
    levels.append(frontier)
    width *= k
  for k in FANOUTS:
    w = default_window(k)
    a_indptr, a_indices, a_seeds = arm_graph(torch, DEVICE, k, w)
    gen = torch.Generator(device=DEVICE).manual_seed(k)
    u = torch.rand(a_seeds.numel(), k, device=DEVICE, generator=gen)
    g = torch.rand(a_seeds.numel(), w, device=DEVICE, generator=gen)
    g[:, ::7] = 0.5                                   # ties in every row
    _, rec = check_sampler(torch, ops, timer, a_indptr, a_indices, a_seeds,
                           k, u, g)
    if min(rec['arms'].values()) == 0:
      raise AssertionError(f'arm check missed an arm: {rec["arms"]}')
    emit('kernel', kernel='sample_one_hop', shape='every arm', **rec)
  tree = torch.cat([lvl.view(16, -1) for lvl in levels], dim=1).reshape(-1)
  gathers = [check_gather(torch, ops, timer, feats, tree)]
  emit('kernel', kernel='gather_rows', shape='16-seed tree', **gathers[0])
  feats_bf16 = feats.to(torch.bfloat16)
  gathers.append(check_gather(torch, ops, timer, feats_bf16, tree))
  emit('kernel', kernel='gather_rows', shape='16-seed tree', **gathers[1])
  del feats_bf16

  # -- serve ------------------------------------------------------------
  eng, launches = serve(torch, ds)
  small_cross_check(torch)
  if '--profile' in argv:
    profile(torch, eng)

  # -- summary ----------------------------------------------------------
  f32 = gathers[0]
  kernels = [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': launches['sample_one_hop'],
       'max_abs_err': max(h['max_abs_err'] for h in hops),
       'ms': sum(h['kernel_ms'] for h in hops),
       'plain_ms': sum(h['plain_ms'] for h in hops),
       'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
       'bound_by': 'bytes',
       'library_ms': None, 'byte_equal': True,
       'shape': '16-seed dispatch, hops of 16/240/2400 rows, k 15/10/5'},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': launches['gather_rows'],
       'max_abs_err': f32['max_abs_err'], 'ms': f32['kernel_ms'],
       'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_us'] / 1e3,
       'bound_by': 'bytes', 'library_ms': f32['library_ms'],
       'byte_equal': True,
       'shape': f'{f32["ids"]} ids x {FEAT_DIM} f32 (16-seed tree)'},
  ]
  return kernels


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
