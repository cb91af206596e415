"""``ray_tpu_torch.data`` against ``ray_tpu.data`` on the same numpy
inputs, on the CPU.

- Blocks: ``_to_table`` and ``BlockAccessor.to_numpy`` (tensor columns
  included) give the same schema, metadata and arrays; a torch tensor
  column (where a JAX one holds a ``jax.Array``) makes the same table; a
  row holding an array and a bf16 column are refused by both.
- ``iter_batches`` over the same blocks, with and without the seeded
  local shuffle buffer, yields the same batches.
- On each package's runtime in turn: ``random_shuffle``, ``sort``,
  ``groupby`` and ``streaming_split`` give the same rows (the shuffle
  the same order), and ``map_batches`` returning torch tensors (JAX:
  ``jax.Array``) the same rows.
- A dataset runs in two runtime sessions in one process, and a remote
  function cached across them is exported to the second session even
  where its runtime takes the first one's address.
- A multi-MB Arrow table crosses the port's store out of band: stored
  once, read back as a view of the store's pages, equal buffer by
  buffer.

The bar is exact equality: the data path moves values, it computes
none (the aggregates' float sums at 1e-5).
"""

import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.data import block as jblock
from ray_tpu.data.iterator import iter_batches_over_blocks as jiter
from ray_tpu_torch.data import block as tblock
from ray_tpu_torch.data.iterator import iter_batches_over_blocks as titer

RTOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return {"id": np.arange(12, dtype=np.int64),
            "x": rng.standard_normal(12).astype(np.float32),
            "img": rng.integers(0, 255, (12, 3, 4, 2)).astype(np.uint8),
            "emb": rng.standard_normal((12, 5)).astype(np.float32)}


def _assert_tables_equal(a: pa.Table, b: pa.Table):
    assert a.schema.equals(b.schema, check_metadata=True), (a.schema,
                                                            b.schema)
    assert a.equals(b)


def _assert_batches_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_to_table_and_to_numpy_match_with_tensor_columns():
    data = _inputs()
    jt, tt = jblock._to_table(data), tblock._to_table(data)
    _assert_tables_equal(jt, tt)
    _assert_batches_equal(jblock.BlockAccessor(jt).to_numpy(),
                          tblock.BlockAccessor(tt).to_numpy())
    assert tblock.BlockAccessor(tt).to_numpy()["img"].shape == (12, 3, 4, 2)


def test_a_torch_column_makes_the_table_a_jax_column_makes():
    data = {k: jnp.asarray(v) for k, v in _inputs().items()}
    jt = jblock._to_table(data)
    tt = tblock._to_table({k: torch.tensor(np.asarray(v))
                           for k, v in data.items()})
    _assert_tables_equal(jt, tt)
    data = _inputs()
    # a tensor that takes part in autograd comes to the host as its values
    grad = torch.from_numpy(data["emb"]).requires_grad_(True)
    _assert_tables_equal(tblock._to_table({"emb": grad}),
                         jblock._to_table({"emb": data["emb"]}))


def test_both_refuse_a_bf16_column():
    x = np.ones((4, 3), np.float32)
    with pytest.raises(pa.ArrowNotImplementedError):
        jblock._to_table({"h": jnp.asarray(x, jnp.bfloat16)})
    with pytest.raises(pa.ArrowNotImplementedError):
        tblock._to_table({"h": torch.from_numpy(x).to(torch.bfloat16)})
    with pytest.raises(pa.ArrowNotImplementedError):
        jblock._to_table({"h": x.astype(ml_dtypes.bfloat16)})


def test_both_refuse_an_array_in_a_row():
    for mod, arr in ((jblock, jnp.arange(3.0)),
                     (tblock, torch.arange(3.0))):
        b = mod.BlockAccessor.builder()
        b.add({"x": arr})
        with pytest.raises(pa.ArrowInvalid):
            b.build()


@pytest.mark.parametrize("shuffle", [None, 7])
@pytest.mark.parametrize("batch_size, drop_last", [(5, False), (5, True),
                                                   (None, False)])
def test_iter_batches_over_the_same_blocks(shuffle, batch_size, drop_last):
    data = _inputs()
    table = tblock._to_table(data)
    blocks = [table.slice(0, 5), table.slice(5, 0), table.slice(5, 7)]
    kw = dict(batch_size=batch_size, batch_format="numpy",
              drop_last=drop_last,
              shuffle_buffer_size=6 if shuffle is not None else None,
              shuffle_seed=shuffle)
    got = list(titer(iter(blocks), **kw))
    want = list(jiter(iter(blocks), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def _pipelines(pkg):
    """Every pipeline of the runtime parity test, on one package."""
    rd = pkg.data
    items = [{"g": int(i % 3), "k": int(k), "v": float(i) / 3}
             for i, k in enumerate(np.random.default_rng(3).permutation(40))]
    out = {
        "shuffle": [r["id"] for r in rd.range(64, parallelism=4)
                    .random_shuffle(seed=7).take_all()],
        "sort": [r["k"] for r in rd.from_items(items, parallelism=4)
                 .sort("k", descending=True).take_all()],
        "groupby": sorted((r["g"], r["v_sum"]) for r in
                          rd.from_items(items, parallelism=3)
                          .groupby("g").sum("v").take_all()),
        "split": [sorted(int(i) for b in s.iter_batches(batch_size=8)
                         for i in b["id"])
                  for s in rd.range(40, parallelism=4).streaming_split(2)],
    }
    return out


#: a pipeline run on a runtime must finish within this
RUN_TIMEOUT_S = 180.0


def _run_on(pkg, fn):
    """``fn(pkg)`` on a fresh runtime of ``pkg``, failing if it has not
    returned within RUN_TIMEOUT_S."""
    pkg.init(num_cpus=4, _num_initial_workers=2)
    box = {}

    def run():
        try:
            box["out"] = fn(pkg)
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            box["err"] = e
    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(RUN_TIMEOUT_S)
        assert not t.is_alive(), \
            f"{fn.__name__} on {pkg.__name__} ran past {RUN_TIMEOUT_S} s"
        if "err" in box:
            raise box["err"]
        return box["out"]
    finally:
        pkg.shutdown()


def test_shuffle_sort_groupby_and_split_match_across_the_packages():
    want = _run_on(ray_tpu, _pipelines)
    got = _run_on(ray_tpu_torch, _pipelines)
    assert got["shuffle"] == want["shuffle"]
    assert sorted(got["shuffle"]) == list(range(64))
    assert got["sort"] == want["sort"] == sorted(want["sort"], reverse=True)
    assert [g for g, _ in got["groupby"]] == [g for g, _ in want["groupby"]]
    np.testing.assert_allclose([v for _, v in got["groupby"]],
                               [v for _, v in want["groupby"]], rtol=RTOL)
    assert got["split"] == want["split"]
    assert sorted(got["split"][0] + got["split"][1]) == list(range(40))


def _tensor_rows(pkg):
    import cloudpickle

    def jax_rows(batch):
        import jax.numpy as jnp
        return {"id": jnp.asarray(batch["id"]),
                "sq": jnp.asarray(batch["id"], jnp.float32)[:, None]
                * jnp.ones((1, 3), jnp.float32)}

    def torch_rows(batch):
        import torch
        t = torch.as_tensor(batch["id"])
        return {"id": t, "sq": t.to(torch.float32)[:, None]
                * torch.ones((1, 3))}

    fn = torch_rows if pkg is ray_tpu_torch else jax_rows
    cloudpickle.register_pickle_by_value(__import__(__name__))
    try:
        ds = pkg.data.range(10, parallelism=2).map_batches(fn)
        return [(r["id"], list(r["sq"])) for r in ds.take_all()]
    finally:
        cloudpickle.unregister_pickle_by_value(__import__(__name__))


def test_map_batches_returning_tensors_matches_jax_arrays():
    want = _run_on(ray_tpu, _tensor_rows)
    got = _run_on(ray_tpu_torch, _tensor_rows)
    assert got == want and len(got) == 10
    assert got[3] == (3, [3.0, 3.0, 3.0])


def test_a_dataset_runs_in_two_sessions_in_one_process():
    from ray_tpu_torch.data._internal import plan
    for i in range(2):
        got = _run_on(ray_tpu_torch, lambda pkg: [
            r["id"] for r in pkg.data.range(12, parallelism=3)
            .random_shuffle(seed=1).take_all()])
        assert sorted(got) == list(range(12)), i
    assert plan._stage_stream_cached   # the cached stage function served both


def test_a_cached_remote_function_reaches_a_session_at_the_same_address(
        monkeypatch):
    """A cached remote function (or actor class) remembers the runtimes
    it was exported to. A runtime collected after shutdown can leave its
    address, its ``id()``, to the next one; the export must still reach
    the new runtime. Here every ``id()`` those modules take is one."""
    from ray_tpu_torch import actor, remote_function

    class WorkerID:
        def __init__(self):
            self.raw = os.urandom(16)

        def binary(self):
            return self.raw

    class Runtime:
        def __init__(self):
            self.worker_id = WorkerID()
            self.exports = []

        def export_function(self, key, blob):
            self.exports.append(key)

    for mod in (actor, remote_function):
        monkeypatch.setattr(mod, "id", lambda obj: 1, raising=False)

    class Cls:
        pass

    for cached in (remote_function.RemoteFunction(lambda x: x),
                   actor.ActorClass(Cls)):
        first, second = Runtime(), Runtime()
        cached._ensure_exported(first)
        cached._ensure_exported(second)
        cached._ensure_exported(second)
        assert len(first.exports) == len(second.exports) == 1


def test_an_arrow_table_crosses_the_store_out_of_band():
    from ray_tpu_torch.core.global_state import global_worker
    rng = np.random.default_rng(0)
    table = tblock._to_table({
        "x": rng.standard_normal(1 << 20).astype(np.float32),
        "img": rng.integers(0, 255, (1 << 20, 3, 3)).astype(np.uint8)})
    assert table.nbytes > 8 << 20
    ray_tpu_torch.init(num_cpus=2, _num_initial_workers=1)
    try:
        seg = global_worker().shm._segment()
        used0 = seg.stats()[0]
        ref = ray_tpu_torch.put(table)
        stored = seg.stats()[0] - used0
        # stored once: the buffers and a small pickle stream
        assert table.nbytes <= stored <= table.nbytes + (256 << 10), stored
        got = ray_tpu_torch.get(ref, timeout=60)
        assert got.equals(table)
        for name in table.column_names:
            want_bufs = table[name].combine_chunks().buffers()
            got_bufs = got[name].chunks[0].buffers()
            for w, g in zip(want_bufs, got_bufs):
                if w is None:
                    continue
                assert g.equals(w)
                # a view of the store's pages, not a copy
                assert seg.base <= g.address < seg.base + seg.total
        del got
    finally:
        ray_tpu_torch.shutdown()
