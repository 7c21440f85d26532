"""I/O layer: pgzf parallel gzip, file readers/writers (port of bsalign_tpu.io)."""
