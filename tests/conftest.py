"""Shared test config.

NOTE: do NOT set XLA_FLAGS / device-count overrides here — smoke tests and
benches must see the real single CPU device; only launch/dryrun.py forces
512 placeholder devices (in its own process).
"""

import numpy as np
import pytest

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # hypothesis is an optional [test] extra; property-test modules fall
    # back to the seeded sampler in tests/_hyp_fallback.py.
    settings = None

if settings is not None:
    # Keep hypothesis fast on the single-core CI box.
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolate_compilation_cache():
    """Opening a plan store points jax's process-global persistent
    compilation cache at ``<store>/xla-cache`` (DESIGN_PERSIST.md).  In
    tests the store is a tmp dir pytest deletes, which would leave every
    *later* test compiling against a vanished cache dir (a UserWarning
    per compile).  Restore the config — and drop jax's first-compile
    latch so the restore takes — whenever a test changed it."""
    import jax

    try:
        before = jax.config.jax_compilation_cache_dir
    except AttributeError:  # jax leg without the option: nothing to leak
        yield
        return
    yield
    if jax.config.jax_compilation_cache_dir != before:
        jax.config.update("jax_compilation_cache_dir", before)
        try:
            from jax._src import compilation_cache as _cc
            _cc.reset_cache()
        except Exception:
            pass
