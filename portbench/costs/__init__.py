"""The benchmark's yardstick for rooflines: bytes and operations of the
port's kernels from the shapes of the plan a run built (``frozen.py``),
the general Matern's series terms (``bessel_terms.py``), the published
peaks (``peaks.json``), and one file a layer that sums its kernels' costs
for a step (``<layer>.py``, found by the layer's name)."""
