"""The JAX package's ``tests/util/test_iter_misc.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): the internal KV and
the tqdm_ray records of ``experimental/``, the parallel iterators of
``util/iter.py`` and the dask shim's gate, and the log monitor rendering
a worker's record. Every body is loaded.
"""

import io
import time

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("util/test_iter_misc.py"))


def test_log_monitor_renders_a_worker_s_tqdm_record(tmp_path):
    """A worker's log line holding a tqdm_ray record is rendered by the
    driver's log monitor, not echoed raw; a plain line is echoed."""
    from ray_tpu_torch.core.log_monitor import LogMonitor
    from ray_tpu_torch.experimental import tqdm_ray
    logs = tmp_path / "logs"
    logs.mkdir()
    out = io.StringIO()
    mon = LogMonitor(str(tmp_path), out=out, poll_s=0.05)
    mon.start()
    try:
        (logs / "worker-abc.out").write_text(
            tqdm_ray.MAGIC + '{"desc": "epochs", "n": 3, "total": 4, '
            '"pos": 0, "final": false}\nplain line\n')
        deadline = time.monotonic() + 20
        while "plain line" not in out.getvalue() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        mon.stop()
    text = out.getvalue()
    assert "epochs: [" in text and "3/4 (75%)" in text, text
    assert tqdm_ray.MAGIC not in text
    assert "plain line" in text


def _iterators_and_pool(pkg):
    """``util.iter``'s parallel iterators and ``util.multiprocessing``'s
    ``Pool`` on ``pkg``'s runtime: what each gives."""
    from importlib import import_module
    it = import_module(pkg.__name__ + ".util.iter")
    mp = import_module(pkg.__name__ + ".util.multiprocessing")
    out = {}
    a = it.from_items(list(range(20)), num_shards=3)
    out["items"] = sorted(a.for_each(lambda x: x * x)
                          .filter(lambda x: x % 2 == 0).gather_sync())
    b = it.from_range(12, num_shards=2).batch(5)
    out["batches"] = list(b.gather_sync())
    c = it.from_range(6, num_shards=2).batch(2).flatten()
    u = c.union(it.from_items(["a", "b"], num_shards=1))
    out["union"] = sorted(map(str, u.gather_async()))
    out["take"] = it.from_range(30, num_shards=3).take(7)
    for p in (a, b, u):
        p.stop()
    with mp.Pool(processes=2) as pool:
        out["map"] = pool.map(lambda x: x + 1, range(6))
        out["starmap"] = pool.starmap(lambda x, y: x * y,
                                      [(1, 2), (3, 4), (5, 6)])
        out["imap"] = list(pool.imap(lambda x: -x, range(4)))
        out["imap_unordered"] = sorted(pool.imap_unordered(
            lambda x: x * 3, range(4)))
        out["apply"] = pool.apply(lambda x, y: x - y, (9, 4))
        r = pool.map_async(lambda x: x % 3, range(5))
        r.wait(timeout=60)
        out["map_async"] = (r.ready(), r.successful(), r.get(timeout=60))
    return out


def test_iterators_and_pool_give_the_jax_packages_results():
    import threading

    import ray_tpu
    import ray_tpu_torch
    got = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        own = not pkg.is_initialized()     # a loaded body's module runtime
        if own:
            pkg.init(num_cpus=4, _num_initial_workers=2)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            out=_iterators_and_pool(pkg)), daemon=True)
        try:
            t.start()
            t.join(180)
            assert not t.is_alive(), f"{pkg.__name__}'s iterators hung"
            got[pkg.__name__] = box["out"]
        finally:
            if own:
                pkg.shutdown()
    assert got["ray_tpu"]["map"] == [1, 2, 3, 4, 5, 6]
    assert got["ray_tpu_torch"] == got["ray_tpu"]
