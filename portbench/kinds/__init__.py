"""The kinds of traffic, one module each, found by the name in a traffic
file's ``entry`` (``lib.entries.load_kind``): nothing outside a kind's
module knows what its step does.  A kind module gives

- ``Entry(spec, inputs, traffic, dtype, device)``: the call into the port,
  one step a call: ``entry(point) -> (value, gradient or None)``, read
  back to the host; ``Entry.grad`` says whether it gives a gradient.  It
  may keep facts of each step (an iteration count) for ``passes``.
- ``inputs(locs, traffic, seed, device)``: what the entry consumes, one
  tensor on ``device`` drawn from ``--seed``.
- ``points(traffic, count)``: the first ``count`` steps' points.
- ``check(traffic, outs, pts, ref_arrays, locs, inputs_host, seed_rng,
  device) -> (correct, checks, steps checked)``: the comparison with the
  plain reference (``portbench/reference/``, or a reference module of its
  own there), after the window, with ``inputs_host`` the inputs as a numpy
  array and ``ref_arrays`` the reference's spec and levels.  It imports
  nothing of the port.
- ``passes(spec, traffic, pts, dtype, device, entry) -> [lib.trace.Step]``:
  the window's priced passes, which each layer's cost file sums; a step
  may be several passes.

and may give ``corners(spec, inputs, traffic, device)``, the rows
``control.py --corners`` prints."""
