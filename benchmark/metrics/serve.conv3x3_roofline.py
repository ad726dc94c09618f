"""serve.conv3x3_roofline: portbench.spans.conv3x3_roofline in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.spans import conv3x3_roofline as read  # noqa: F401
