"""Test configuration.

By default the suite runs on the CPU backend with 8 virtual devices, so
the multi-device sharding paths are exercised without a GPU.

GSDF_TEST_GPU=1 makes the GPU the default platform (the CPU backend and
its 8 virtual devices stay available as the oracle) and is how the
`gpu`-marked tests run on a card:

    GSDF_TEST_GPU=1 python -m pytest tests -m gpu -p no:xdist

It fails at start-up when no GPU is found: a run that asked for the card
never carries on on the CPU."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("GSDF_TEST_GPU") == "1":
    jax.config.update("jax_platforms", "cuda,cpu")
    if jax.devices()[0].platform != "gpu":
        raise RuntimeError("GSDF_TEST_GPU=1 but JAX found no GPU")
else:
    jax.config.update("jax_platforms", "cpu")

_GPU_SKIP = (
    "needs a GPU: GSDF_TEST_GPU=1 python -m pytest tests -m gpu -p no:xdist"
)


def pytest_collection_modifyitems(config, items):
    # slow tests run only when explicitly selected (`pytest -m slow`)
    if config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow golden render; run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


def _first_gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    return devs[0] if devs else None


@pytest.fixture(autouse=True)
def _gpu_marker_gate(request):
    """`gpu`-marked tests skip unless a GPU backend is up. Decided here,
    when the test runs, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") and _first_gpu() is None:
        pytest.skip(_GPU_SKIP)


@pytest.fixture
def gpu_device():
    """The first GPU device (the test skips where there is none)."""
    dev = _first_gpu()
    if dev is None:
        pytest.skip(_GPU_SKIP)
    return dev
