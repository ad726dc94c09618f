"""serve.mfu: portbench.readers.serve_mfu in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.readers import serve_mfu as read  # noqa: F401
