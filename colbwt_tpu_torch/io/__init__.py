"""File formats, FASTA reading, PML/CID writers and the native host
library — the port's own copy of colbwt_tpu/io/ (NumPy and ctypes only)."""

from colbwt_tpu_torch.io.formats import (  # noqa: F401
    read_fixed_ints,
    write_fixed_ints,
    read_rlbwt,
    write_rlbwt,
    read_col_mums,
    write_col_mums,
    read_thresholds_file,
    write_thresholds_file,
    read_col_ids,
    write_col_ids,
    read_sdsl_bit_vector,
    write_sdsl_bit_vector,
    write_plain_bwt,
    read_plain_bwt,
    write_col_pml_file,
    read_col_pml_file,
    encode_sd_vector,
    decode_sd_vector,
    encode_select_support_mcl,
    decode_select_support_mcl,
    select_support_mcl_query,
    write_sdsl_sd_vector,
    read_sdsl_sd_vector,
    write_fl_table_file,
    read_fl_table_file,
)
from colbwt_tpu_torch.io.fasta import read_fasta, write_fasta, FastaRecord  # noqa: F401
from colbwt_tpu_torch.io.pml_out import (  # noqa: F401
    write_pml_cid_text,
    write_pml_cid_binary,
    read_pml_cid_binary,
)
