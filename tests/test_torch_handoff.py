"""The planned `PartitionBook` handoff in the port against the JAX
package at P = 8: `PartitionBook.transfer`'s one bump and its separate
ledger, its refusal ladder (the same typed messages), the fenced seam
ladder of `parallel.handoff.handoff` — a mid-epoch handoff leaves the
epoch byte-identical to the run without one (and to JAX's handoff
epoch) with exactly one bump and one recorder event a seam, a chaos kill
at any seam before the cutover unwinds to the source (book untouched,
nothing staged, the epoch still exact), a drain-seam fault is absorbed
— and the handoff's durable shard is the JAX package's, byte for byte.
Tolerance: batches, books, ledgers and recorder facts exact.
"""
import numpy as np
import pytest

from graphlearn_tpu.parallel import handoff as jho
from graphlearn_tpu.parallel import failover as jfo
from graphlearn_tpu.parallel import partition_book as jpb
from graphlearn_tpu.telemetry.recorder import recorder as jrecorder
from graphlearn_tpu.testing import chaos as jchaos
from graphlearn_tpu_torch.parallel import failover as tfo
from graphlearn_tpu_torch.parallel import handoff as tho
from graphlearn_tpu_torch.parallel import partition_book as tpb
from graphlearn_tpu_torch.telemetry import recorder as trecorder
from graphlearn_tpu_torch.testing import chaos as tchaos
from test_torch_partition_failover import (P, assert_books_equal,
                                           assert_epochs_equal, batch_np,
                                           jax_dataset, jax_loader,
                                           port_dataset, port_loader,
                                           reference)

#: the two packages' (handoff, failover, book, chaos, recorder, dataset,
#: loader) modules and factories
PKGS = {'jax': (jho, jfo, jpb, jchaos, jrecorder, jax_dataset, jax_loader),
        'port': (tho, tfo, tpb, tchaos, trecorder, port_dataset,
                 port_loader)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for k in ('GLT_SHARD_DIR', 'GLT_DEGRADED_OK', 'GLT_FAULT_PLAN'):
    monkeypatch.delenv(k, raising=False)


def _enable(rec, pkg):
  if pkg == 'jax':
    rec.enable(None)
  else:
    rec.enable()
  rec.clear()


def test_book_transfer_one_bump_separate_ledger():
  books = []
  for pb in (jpb, tpb):
    book = pb.PartitionBook(np.arange(P + 1) * 10)
    v0 = book.view()
    v1 = book.transfer(3, 3, 5)
    assert v0.version == 0 and int(v0.owners[3]) == 3
    assert v1.version == 1 and int(v1.owners[3]) == 5
    assert book.transfers() == [{'range': 3, 'frm': 3, 'to': 5,
                                 'version': 1}]
    assert book.adoptions() == []
    books.append(book)
  assert_books_equal(*books)


def test_book_transfer_refusal_ladder():
  msgs = []
  for pb in (jpb, tpb):
    book = pb.PartitionBook(np.arange(P + 1))
    got = []
    for args in ((99, 99, 0), (3, 5, 5), (3, 4, 5)):
      with pytest.raises(pb.AdoptionRefusedError) as ei:
        book.transfer(*args)
      got.append(str(ei.value))
    book.adopt(3, 5)
    for args in ((3, 5, 6), (1, 1, 3), (1, 1, 5)):
      with pytest.raises(pb.AdoptionRefusedError) as ei:
        book.transfer(*args)
      got.append(str(ei.value))
    assert book.version == 1 and book.transfers() == []
    msgs.append(got)
  assert msgs[0] == msgs[1]
  for m, key in zip(msgs[1], ('out of range', 'itself', 'stale handoff',
                              'off-owner', 'itself dead',
                              'already carries')):
    assert key in m


def test_handoff_requires_durable_store():
  for pkg, (ho, fo, pb, chaos, rec, make_ds, make_loader) in PKGS.items():
    ds = make_ds()
    with pytest.raises(fo.NoDurableShardError, match='GLT_SHARD_DIR'):
      ho.handoff(ds, 3, 5)
    assert ds.partition_book.version == 0, pkg


def test_mid_epoch_handoff_byte_identical(tmp_path):
  """A handoff between batches 3 and 4: the epoch equals the one without
  it in both packages, one bump, one transfer, the staged shard serving
  the range, one event a seam — and the snapshot the handoff wrote is the
  JAX package's shard, byte for byte."""
  ref = reference()
  infos, books, phases, got_all = {}, {}, {}, {}
  for pkg, (ho, fo, pb, chaos, rec, make_ds, make_loader) in PKGS.items():
    ds = make_ds()
    it = iter(make_loader(ds))
    got = [batch_np(next(it)) for _ in range(3)]
    _enable(rec, pkg)
    try:
      infos[pkg] = ho.handoff(ds, 3, 5,
                              store=fo.ShardStore(tmp_path / pkg))
      phases[pkg] = [e['phase'] for e in rec.events('handoff.transfer')]
    finally:
      rec.disable()
      rec.clear()
    got.extend(batch_np(b) for b in it)
    got_all[pkg] = got
    books[pkg] = ds.partition_book
    assert 3 in ds.adopted_shards
  assert_epochs_equal(ref, got_all['jax'], 'jax handoff')
  assert_epochs_equal(ref, got_all['port'], 'port handoff')
  keys = ('partition', 'frm', 'to', 'version', 'drain_fault')
  assert {k: infos['port'][k] for k in keys} == \
      {k: infos['jax'][k] for k in keys} == \
      {'partition': 3, 'frm': 3, 'to': 5, 'version': 1, 'drain_fault': None}
  assert infos['port']['secs'] > 0
  assert_books_equal(books['jax'], books['port'])
  assert books['port'].transfers() == [{'range': 3, 'frm': 3, 'to': 5,
                                        'version': 1}]
  assert books['port'].adoptions() == []
  assert phases['port'] == phases['jax'] == list(tho.SEAMS)
  assert tho.SEAMS == jho.SEAMS
  jl = jfo.ShardStore(tmp_path / 'jax').load_shard(3)
  tl = tfo.ShardStore(tmp_path / 'port').load_shard(3)
  assert set(tl) == set(jl)
  for k in jl:
    assert tl[k].dtype == jl[k].dtype and np.array_equal(tl[k], jl[k]), k


@pytest.mark.parametrize('seam', ('snapshot', 'transfer', 'fence',
                                  'cutover'))
def test_pre_cutover_kill_unwinds_to_source(tmp_path, seam):
  """A kill at any seam before the cutover: `HandoffAbortedError` naming
  the seam, book untouched, nothing staged, a ``rollback`` event — and
  the epoch completes byte-identical on the retained source."""
  ref = reference()
  for pkg, (ho, fo, pb, chaos, rec, make_ds, make_loader) in PKGS.items():
    ds = make_ds()
    it = iter(make_loader(ds))
    got = [batch_np(next(it)) for _ in range(3)]
    chaos.install(f'handoff.transfer:kill:1:op={seam}')
    _enable(rec, pkg)
    try:
      with pytest.raises(ho.HandoffAbortedError) as ei:
        ho.handoff(ds, 3, 5, store=fo.ShardStore(tmp_path / pkg))
      events = rec.events('handoff.transfer')
    finally:
      chaos.uninstall()
      rec.disable()
      rec.clear()
    assert ei.value.seam == seam and ei.value.partition == 3, pkg
    book = ds.partition_book
    assert book.version == 0 and int(book.view().owners[3]) == 3, pkg
    assert book.transfers() == [] and not ds.adopted_shards, pkg
    assert events[-1]['phase'] == 'rollback', pkg
    assert events[-1]['at_seam'] == seam, pkg
    got.extend(batch_np(b) for b in it)
    assert_epochs_equal(ref, got, f'{pkg} {seam}-seam abort')


def test_drain_fault_absorbed(tmp_path):
  """A drain-seam fault comes after the cutover: the move stands and the
  fault is returned, not raised, in both packages."""
  for pkg, (ho, fo, pb, chaos, rec, make_ds, make_loader) in PKGS.items():
    ds = make_ds()
    chaos.install('handoff.transfer:fail:1:op=drain')
    try:
      info = ho.handoff(ds, 3, 5, store=fo.ShardStore(tmp_path / pkg))
    finally:
      chaos.uninstall()
    assert info['version'] == 1 and 'InjectedFault' in info['drain_fault']
    assert ds.partition_book.version == 1
    assert int(ds.partition_book.view().owners[3]) == 5


def test_handoff_refusals_leave_nothing_staged(tmp_path):
  """A refused cutover (a stale source) and a second move of a range with
  a staged shard unwind typed in both packages."""
  for pkg, (ho, fo, pb, chaos, rec, make_ds, make_loader) in PKGS.items():
    ds = make_ds()
    store = fo.ShardStore(tmp_path / pkg)
    with pytest.raises(pb.AdoptionRefusedError, match='stale handoff'):
      ho.handoff(ds, 3, 5, store=store, frm=4)
    assert ds.partition_book.version == 0 and not ds.adopted_shards
    ho.handoff(ds, 3, 5, store=store)
    with pytest.raises(ho.HandoffAbortedError, match='already carries'):
      ho.handoff(ds, 3, 6, store=store)
    assert ds.partition_book.version == 1
    assert set(ds.adopted_shards) == {3}
