"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without real hardware via
--xla_force_host_platform_device_count (SURVEY.md §4 item 5).  The
platform is pinned with jax.config.update (CPU unless MQS_TEST_PLATFORM
says otherwise; MQS_TEST_PLATFORM=gpu runs the suite on a card, where the
`gpu`-marked tests run instead of skipping).

KNOWN ISSUE (round 5): a full `--runslow` run in ONE process can die
with a segfault inside XLA:CPU `backend_compile` after ~45 min of
accumulated compilation state (reproduced twice at
test_slam_fig8_loop_closure_fires_and_corrects at ~80%; the same test
passes standalone in <5 min).  Run the slow set in per-file chunks
(`pytest tests/<file>.py --runslow -m slow`) — the default (non-slow)
suite is unaffected and green in one process (~10 min).
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
)
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("MQS_TEST_PLATFORM", "cpu"))
# entry points under test (cli.main) point JAX's persistent compile cache
# into the checkout; the suite itself compiles fresh
jax.config.update("jax_enable_compilation_cache", False)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (also: MQS_RUN_SLOW=1)")


def pytest_collection_modifyitems(config, items):
    """Skip `slow`-marked tests by default (the serial CPU suite takes
    tens of minutes).  CI / pre-merge runs use --runslow or
    MQS_RUN_SLOW=1 for full coverage; the default run keeps every
    suite's fast representatives so day-to-day iteration stays honest."""
    if config.getoption("--runslow") or os.environ.get("MQS_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow: use --runslow or MQS_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first JAX device for tests marked `gpu`; skips the test when
    that device is not a GPU.  Decided here, at run time, never at
    import or collection (every xdist worker must collect the same
    tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
