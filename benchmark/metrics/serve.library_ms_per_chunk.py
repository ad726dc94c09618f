"""serve.library_ms_per_chunk: portbench.readers.library_ms_per_chunk in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.readers import library_ms_per_chunk as read  # noqa: F401
