"""The harness's parts, shared by every kind of traffic
(``portbench/kinds/``): the cell's files (``cell``), what inputs are made
of (``data``), the caches (``cache``), the port's side (``entries``: the
spec, the plan's shapes and the kinds' loader), the traced window's
reduction (``trace``) and the parts of ``correct`` (``check``).  Of these
only ``entries`` and ``cache`` import the port; so do the kind modules."""
