"""serve.tail_fwd_roofline: portbench.spans.tail_fwd_roofline in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.spans import tail_fwd_roofline as read  # noqa: F401
