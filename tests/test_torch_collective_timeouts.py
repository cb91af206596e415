"""A host collective's KV wait that times out names the key it waited
for and the keys of its group that were present, so a part that never
came can be told from one that came under another name."""

import pytest

from ray_tpu_torch.parallel import collective


class _KV:
    """The runtime KV's calls a wait makes, over a dict."""

    def __init__(self, keys):
        self.keys = dict.fromkeys(keys, b"1")

    def kv_get(self, key, ns=""):
        return self.keys.get(key)

    def kv_del(self, key, ns=""):
        return self.keys.pop(key, None) is not None

    def kv_keys(self, prefix=b"", ns=""):
        return [k for k in self.keys if k.startswith(prefix)]


@pytest.mark.parametrize("wait", [collective._kv_wait, collective._kv_take])
def test_a_timed_out_wait_names_the_groups_present_keys(monkeypatch, wait):
    kv = _KV([b"collective/g/ar/3/0", b"collective/g/ar/3/2",
              b"collective/other/ar/3/1"])
    monkeypatch.setattr(collective, "_kv", lambda: kv)
    with pytest.raises(TimeoutError) as e:
        wait(b"collective/g/ar/3/1", timeout=0.05)
    msg = str(e.value)
    assert "collective/g/ar/3/1" in msg
    assert "collective/g/ar/3/0" in msg and "collective/g/ar/3/2" in msg
    assert "collective/other" not in msg
