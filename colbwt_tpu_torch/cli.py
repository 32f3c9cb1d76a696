"""col-bwt-torch command-line interface: the `col-bwt` flags
(colbwt_tpu/cli.py:85-149) plus --device.

    col-bwt-torch build [-i INPUT] -o OUTPUT [-r] [-m MODE] [-s SUB_SAMPLE]
                        [-l MIN_MUM] [-v] [--force] [--keep] [--clean]
                        [--sa-mode M] [--chunk-chars C] [--no-prewarm]
                        [--device DEV] [fastas ...]
    col-bwt-torch query INDEX -p PATTERN [--text] [-l] [--stream]
                        [--engine E] [--batch-size B] [--device DEV]

The device defaults to cuda and the run fails when CUDA is absent; pass
--device cpu to run the plain PyTorch path.  `build` finds the multi-MUMs
and walks the col-split on the device in both SA lanes (--sa-mode
monolithic, or chunked for collections beyond the host SA budget), then
prewarms the query engine's tables unless --no-prewarm.
`query --stream` is the bounded-memory lane (pipeline/stream.py), with
batches of 32768 reads unless --batch-size says otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode

CLEAN_EXTS = ["bwt", "thr_pos", "col_mums", "bwt.heads", "bwt.len",
              "col_ids", "col_runs", "col_pml"]


def _build(args: argparse.Namespace) -> int:
    from colbwt_tpu_torch.pipeline.build import build_pipeline

    if not args.fastas and not args.input:
        print("Error: either positional 'fastas' or -i/--input is required.",
              file=sys.stderr)
        return 1
    cfg = ColBwtConfig(
        mode=SplitMode(args.mode), split_rate=args.sub_sample,
        min_mum=args.min_mum, rev_comp=args.rev_comp, verbose=args.verbose,
        force=args.force, keep_temp=args.keep,
        sa_mode=args.sa_mode, chunk_chars=args.chunk_chars,
        prewarm=not args.no_prewarm)
    build_pipeline(args.fastas, args.output, cfg, filelist=args.input,
                   device=args.device)
    if args.clean:
        fa = f"{args.output}.fa"
        for ext in CLEAN_EXTS:
            Path(f"{fa}.{ext}").unlink(missing_ok=True)
        Path(f"{args.output}.lengths").unlink(missing_ok=True)
    print(f"Index output at {args.output}.colpml.npz")
    return 0


def _query(args: argparse.Namespace) -> int:
    from colbwt_tpu_torch.pipeline import query_pipeline, query_stream

    if args.batch_size < 0:
        print("Error: --batch-size must be >= 0 (0 = config default).",
              file=sys.stderr)
        return 1
    cfg = ColBwtConfig(verbose=args.verbose, engine=args.engine)
    if args.batch_size:
        cfg.batch_size = args.batch_size
    elif args.stream:
        # bulk streaming defaults to deeper batches, as col-bwt does
        # (colbwt_tpu/cli.py:63-69): per-batch costs amortize, and
        # first-output latency does not matter for a bulk run
        cfg.batch_size = 32768
    if args.stream:
        if args.text:
            print("Error: --stream writes binary outputs only.",
                  file=sys.stderr)
            return 1
        query_stream(args.index, args.pattern, cfg, device=args.device)
    else:
        query_pipeline(args.index, args.pattern, cfg,
                       write_text=args.text and not args.long,
                       write_text_long=args.text and args.long,
                       device=args.device)
    print(f"Output at {args.pattern}.split.pml.bin and "
          f"{args.pattern}.split.cid.bin")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="col-bwt-torch",
        description="Full-text index for pangenomes using chain statistics "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command")
    device_help = ("device to run on (default cuda; fails when CUDA is "
                   "absent — pass cpu for the plain PyTorch path)")

    b = sub.add_parser("build", help="Find multi-MUMs and build the col-bwt")
    b.add_argument("fastas", nargs="*", type=str,
                   help="fasta files to index")
    b.add_argument("-i", "--input", type=str,
                   help="file-list of genomes (overrides positional args)")
    b.add_argument("-o", "--output", required=True, type=str,
                   help="output prefix path")
    b.add_argument("-r", "--rev_comp", action="store_true", default=False,
                   help="include reverse complements")
    b.add_argument("-m", "--mode", type=str, default="tunnels",
                   choices=["tunnels", "all"], help="splitting mode")
    b.add_argument("-s", "--sub-sample", type=int, default=10,
                   help="sub-sample (split) rate")
    b.add_argument("-l", "--min-mum", type=int, default=20,
                   help="minimum multi-MUM length")
    b.add_argument("-v", "--verbose", action="store_true")
    b.add_argument("--force", action="store_true",
                   help="force all build steps to run")
    b.add_argument("--keep", action="store_true",
                   help="keep all temporary files")
    b.add_argument("--clean", action="store_true",
                   help="remove all intermediate files")
    b.add_argument("--sa-mode", type=str, default="auto",
                   choices=["auto", "monolithic", "chunked"],
                   help="suffix-array construction lane: 'chunked' builds "
                        "the RLBWT by per-chunk SA-IS + rank merge (no "
                        "global SA) and streams the multi-MUM scan; 'auto' "
                        "switches to it when n exceeds the host SA budget")
    b.add_argument("--chunk-chars", type=int, default=0,
                   help="chunk size (characters) for --sa-mode chunked; "
                        "0 = auto (half the monolithic SA RAM budget)")
    b.add_argument("--no-prewarm", action="store_true",
                   help="skip the build-exit prewarm (the query engine's "
                        "tables built, and saved under "
                        "OUTPUT.torch_tables/ where loading them beats "
                        "building them)")
    b.add_argument("--device", type=str, default="cuda", help=device_help)

    q = sub.add_parser("query", help="Compute PMLs and chain statistics")
    q.add_argument("index", type=str, help="output prefix of the build")
    q.add_argument("-p", "--pattern", required=True, type=str,
                   help="pattern fasta file")
    q.add_argument("--text", action="store_true",
                   help="also write .pml/.cid text outputs")
    q.add_argument("-l", "--long", action="store_true",
                   help="long-pattern mode: with --text, write the "
                        "reference's -l streaming text format "
                        "(src/pml_query.cpp:32-63)")
    q.add_argument("-v", "--verbose", action="store_true")
    q.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming mode for huge pattern "
                        "files (binary outputs only)")
    q.add_argument("--batch-size", type=int, default=0,
                   help="reads per device batch (0 = config default 8192; "
                        "32768 with --stream)")
    q.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "pos", "mega", "fused", "xla"],
                   help="query engine override (auto picks the fastest "
                        "that fits device memory; mega and fused need a "
                        "run-split index; wide indexes always use "
                        "mega-wide)")
    q.add_argument("--device", type=str, default="cuda", help=device_help)

    args = parser.parse_args(argv)
    if args.command == "build":
        return _build(args)
    if args.command == "query":
        return _query(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
