"""The harness's parts: the cell's files (``cell``), its inputs
(``data``), the caches (``cache``), the system under test (``entries``),
the traced window's reduction (``trace``) and the comparison with the
reference (``check``)."""
