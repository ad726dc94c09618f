"""serve.copy_gb_per_s: portbench.spans.copy_gb_per_s in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.spans import copy_gb_per_s as read  # noqa: F401
