"""serve_unetp.mfu: portbench.readers.serve_mfu in cell unetp-128.serve-r512 (moves serve_unetp_tiles_per_s)."""

from portbench.readers import serve_mfu as read  # noqa: F401
