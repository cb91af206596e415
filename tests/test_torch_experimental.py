"""The JAX package's ``tests/util/test_iter_misc.py`` bodies of
``experimental/`` on the port (loaded by
``tests/test_torch_runtime_loader.py``): the internal KV and the
tqdm_ray records, and the log monitor rendering a worker's record.

Left out, until ROADMAP Queue 1 item 11's last slice ports ``util/``'s
shims: the ``util.iter`` bodies and the dask shim's gate. The module's
``from ray_tpu.util import iter`` is dropped with them.
"""

import io
import time

from test_torch_runtime_loader import FIXTURES, load_core_tests

_UTIL = "util.iter and util.dask wait for ROADMAP Queue 1 item 11 (util/)"

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_parallel_iterator_basics": _UTIL,
    "test_parallel_iterator_transforms": _UTIL,
    "test_parallel_iterator_union_async": _UTIL,
    "test_dask_shim_is_gated": _UTIL,
}

globals().update(FIXTURES)
globals().update(load_core_tests(
    "util/test_iter_misc.py", LEAVE_OUT,
    edits=[("from ray_tpu_torch.util import iter as rt_iter\n", "")]))


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
