"""serve_unetp.head_roofline: portbench.spans.head_roofline in cell unetp-128.serve-r512 (moves serve_unetp_tiles_per_s)."""

from portbench.spans import head_roofline as read  # noqa: F401
