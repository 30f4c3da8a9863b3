"""Device handling, compile cache, image I/O and the plain references
that the on-card smoke run (chip_smoke.py) compares the kernels with."""

import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax.dataio import png
from multi_orbslam3_jax.eval import device
from multi_orbslam3_jax.frontend import fast, matcher, reference
from multi_orbslam3_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = """
import jax, jax.numpy as jnp
from multi_orbslam3_jax.utils.cache import enable_compilation_cache
print(enable_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
"""


def _run(args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cache_uses_env_dir_exactly(tmp_path):
    want = str(tmp_path / "xla")
    r = _run([sys.executable, "-c", _CACHE_PROBE],
             {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()[:2]
    assert used == want and configured == want
    assert os.listdir(want), "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_cache_default_dir_is_fixed_inside_checkout():
    r = _run([sys.executable, "-c", _CACHE_PROBE],
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    used = r.stdout.split()[0]
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    # the CPU backend keys its entries by host CPU flags, one level down
    assert os.path.dirname(used) == cache.DEFAULT_DIR


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_backend(script):
    r = _run([sys.executable, script])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"metric"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"},
      {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("", []),
])
def test_parse_cards(text, want):
    assert device.parse_cards(text) == want


def test_fast_reference_equals_jnp_at_euroc_width():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (480, 752)).astype(np.float32)
    got = np.asarray(fast.nms3x3(fast.fast_score(jnp.asarray(img), 7.0)))
    want = reference.fast_score_nms(img, 7.0)
    assert (want > 0).sum() > 1000
    np.testing.assert_array_equal(got, want)


def test_hamming_reference_equals_jnp_at_arena_width():
    rng = np.random.RandomState(1)
    d1 = rng.randint(0, 2 ** 32, (16384, 8), dtype=np.uint32)
    d2 = rng.randint(0, 2 ** 32, (1024, 8), dtype=np.uint32)
    got = np.asarray(matcher.hamming_matrix(jnp.asarray(d1),
                                            jnp.asarray(d2)))
    np.testing.assert_array_equal(got, reference.hamming_matrix(d1, d2))


def _filtered_png(img: np.ndarray) -> bytes:
    """PNG with scanline filter types 0-4 in turn (what libpng's adaptive
    filtering writes), built from the PNG specification's definitions."""
    h, w = img.shape
    rows = []
    prev = np.zeros(w, np.int32)
    for y in range(h):
        cur = img[y].astype(np.int32)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        kind = y % 5
        if kind == 0:
            pred = np.zeros(w, np.int32)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    raw = png.encode_gray(np.zeros((h, w), np.uint8))
    head = raw[:33]                                  # signature + IHDR
    idat = zlib.compress(b"".join(rows))
    return head + png._chunk(b"IDAT", idat) + png._chunk(b"IEND", b"")


def test_png_round_trip(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (37, 53)).astype(np.uint8)
    path = str(tmp_path / "f.png")
    png.write_gray(path, img)
    np.testing.assert_array_equal(png.read_gray(path), img)


def test_png_decodes_every_filter_type():
    img = np.random.RandomState(3).randint(0, 256, (25, 41)).astype(np.uint8)
    np.testing.assert_array_equal(png.decode_gray(_filtered_png(img)), img)


def test_png_rejects_colour():
    data = bytearray(png.encode_gray(np.zeros((4, 4), np.uint8)))
    data[25] = 2                                     # colour type: RGB
    with pytest.raises(ValueError):
        png.decode_gray(bytes(data))


@pytest.mark.gpu
def test_kernels_equal_references_on_card(gpu):
    from multi_orbslam3_jax.eval import benchmarks
    rec = benchmarks.bench_kernels()
    assert rec["ok"], rec
