"""serve_unetp.library_ms_per_chunk: portbench.readers.library_ms_per_chunk in cell unetp-128.serve-r512 (moves serve_unetp_tiles_per_s)."""

from portbench.readers import library_ms_per_chunk as read  # noqa: F401
