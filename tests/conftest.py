"""Gate tests whose optional dependencies are absent in this image."""
collect_ignore = []

try:
    import hypothesis  # noqa: F401
except ImportError:
    collect_ignore.append("test_property.py")
    collect_ignore.append("test_simulator_invariants.py")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skipped without one")
