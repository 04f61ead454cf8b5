"""Runtime rules: matmul precision of the frame program, the compilation
cache's location, and the on-card smoke test's refusal to run without a
GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_frame_program_pins_f32_matmul_precision():
    """Every f32 dot of the fused frame program carries HIGHEST precision,
    even when the caller's default precision says otherwise."""
    import __graft_entry__ as ge
    from nrslam.slam import system as system_mod

    state, pyr1, cam, config, shape = ge._small_problem()
    mask = jnp.ones(shape, bool)
    with jax.default_matmul_precision("default"):
        text = system_mod._fused_frame_impl.lower(
            state, pyr1[0][0], mask, cam.params, cam.kind, config,
            True).as_text()
    dots = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    f32_dots = [l for l in dots if "xf32>" in l.split(" : ")[-1]]
    assert f32_dots, "no f32 dot in the frame program"
    unpinned = [l.strip() for l in f32_dots if "HIGHEST" not in l]
    assert not unpinned, unpinned[:3]


_CACHE_PROBE = """
import json, jax, jax.numpy as jnp
from nrslam.utils import compile_cache
chosen = compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2.0 + 1.0)(jnp.ones(3)).block_until_ready()
print(json.dumps({"chosen": chosen,
                  "config": jax.config.jax_compilation_cache_dir}))
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_location(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set (and the cache lands there);
    otherwise the cache is <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    want = str(ROOT / ".jax_cache")
    if env_set:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"chosen": want, "config": want}
    assert any(Path(want).iterdir())


def test_chip_smoke_device_phase_fails_without_gpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
