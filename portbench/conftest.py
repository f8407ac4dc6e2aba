"""pytest settings of the benchmark's own tests (``portbench/tests``):
the marker of the tests that need a CUDA card.  Whether a card is there is
decided inside each such test, never while a module is imported."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips itself without one")
