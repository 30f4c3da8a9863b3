"""Test configuration.

Every test runs on a virtual 8-device CPU mesh, so the multi-device
paths run without accelerators, except under ``-m gpu``: then JAX keeps
the machine's GPU and only the tests marked ``gpu`` run (on a machine
with an NVIDIA GPU: ``python -m pytest tests/ -m gpu``). A ``gpu`` test
skips wherever the first JAX device is not a GPU.
"""

import os

# XLA:CPU's LLVM backend segfaulted reproducibly while compiling the
# largest fused program (the stereo mapping chain) ~150 tests into a
# full run, yet the same compile succeeds in a fresh process. Two
# mitigations: a much larger main-thread stack (LLVM's recursive passes
# are the prime SIGSEGV suspect on a deep program), and collection
# reordering below so the biggest compiles happen first, while the
# process is small.
try:
    import resource
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 512 * 1024 * 1024
    if _soft != resource.RLIM_INFINITY and _soft < _want:
        resource.setrlimit(
            resource.RLIMIT_STACK,
            (min(_want, _hard) if _hard != resource.RLIM_INFINITY
             else _want, _hard))
except (ImportError, ValueError, OSError):
    pass

import jax  # noqa: E402
import pytest  # noqa: E402


def _on_card(config) -> bool:
    return (config.getoption("markexpr") or "").strip() == "gpu"


def pytest_configure(config):
    on_card = _on_card(config)
    if not on_card:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        # an installed accelerator plugin can set jax_platforms at
        # start-up, over the environment: force the config itself
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    # persistent compilation cache: the suite compiles hundreds of
    # programs; re-using them across runs cuts CI time AND avoids
    # re-entering the LLVM compile paths that intermittently segfault a
    # small host under load
    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    if not on_card and jax.default_backend() != "cpu":
        raise pytest.UsageError("tests must run on the virtual CPU mesh, "
                                "got " + jax.default_backend())


@pytest.fixture
def gpu():
    """The first JAX device, which must be an NVIDIA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest tests/ -m gpu")
    return dev


# Compile-heavy modules first: their big XLA programs build while the
# process heap/LLVM state is still small (see the SIGSEGV note above).
# Everything else keeps collection order.
_HEAVY_FIRST = (
    "test_stereo.py", "test_stereo_inertial.py", "test_inertial_pipeline.py",
    "test_kb8_pipeline.py", "test_collab_inertial.py",
)


def pytest_collection_modifyitems(config, items):
    def rank(item):
        name = os.path.basename(str(item.fspath))
        return (_HEAVY_FIRST.index(name) if name in _HEAVY_FIRST
                else len(_HEAVY_FIRST))
    items.sort(key=rank)


# Release compiled executables between modules: the roaming SIGSEGVs
# (LLVM compile at 96%, cache-write serialization at 90%) only appear
# once a single process has accumulated hundreds of live XLA
# executables. Dropping them bounds native-heap growth; re-entry is a
# cheap persistent-cache load, not a recompile.
@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
