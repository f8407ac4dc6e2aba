"""Readers of per-layer metrics: ``read(ctx, **args)`` returns the number,
or None where the traced window holds nothing to read.  A metric's file
``metrics/<name>.json`` names its reader and the reader's arguments."""
