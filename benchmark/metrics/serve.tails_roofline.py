"""serve.tails_roofline: portbench.readers.serve_tails_roofline in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.readers import serve_tails_roofline as read  # noqa: F401
