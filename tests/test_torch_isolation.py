"""The port stands alone: no file of ``ray_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the port imports,
serves and takes a train step with both made unimportable."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "optax", "flax", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert path.exists(), path
    bad = sorted({m for m in _imported_roots(path) if m in BANNED})
    assert not bad, f"{path.name} imports {bad}"


def test_port_serves_with_jax_and_ray_tpu_unimportable():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu"):
            sys.modules[name] = None      # any import of them now fails
        import torch
        torch.set_num_threads(1)
        from ray_tpu_torch.models import TransformerConfig
        from ray_tpu_torch.serve import EngineConfig, LLMEngine
        cfg = TransformerConfig(vocab_size=64, d_model=16, n_layers=2,
                                n_heads=2, head_dim=8, d_ff=32,
                                max_seq_len=64, rotary_dim=8,
                                dtype=torch.float32)
        eng = LLMEngine(cfg, EngineConfig(decode_slots=2, kv_block_size=4,
                                          max_seq_len=32, prefill_chunk=8),
                        seed=0, device="cpu")
        try:
            toks = list(eng.generate_sync([1, 2, 3, 4, 5], 6))
            assert len(toks) == 6, toks
            assert eng.pool_audit() == []
        finally:
            eng.shutdown()
        from ray_tpu_torch.models import make_train_step
        bundle = make_train_step(cfg, learning_rate=1e-3, device="cpu")
        state = bundle.init(seed=0)
        state, m = bundle.step(state, {"input_ids": torch.randint(
            0, 64, (2, 16), generator=torch.Generator().manual_seed(0))})
        assert torch.isfinite(m["loss"]) and int(state["step"]) == 1, m
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
