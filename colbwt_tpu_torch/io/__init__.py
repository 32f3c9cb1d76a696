"""File formats, FASTA reading, PML/CID writers and the native host
library — the port's own copy of colbwt_tpu/io/ (NumPy and ctypes only)."""
