"""serve_unetp.copy_gb_per_s: portbench.spans.copy_gb_per_s in cell unetp-128.serve-r512 (moves serve_unetp_tiles_per_s)."""

from portbench.spans import copy_gb_per_s as read  # noqa: F401
