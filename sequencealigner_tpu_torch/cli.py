"""seqalign-torch command line interface.

Port of ``sequencealigner_tpu/cli.py``: the same flag surface, relations,
prompts and main() flow (parse/validate -> header -> configuration actions
-> read dataset -> prepare matrix store -> align -> HDF5 -> benchmark
summary).  The engine runs the CUDA kernels; -C runs their plain PyTorch
versions on the host CPU.  With no CUDA device and no -C the run stops: it
never carries on on the CPU unasked.  -f, -k, -t and multi-host runs are
not ported yet and exit 1.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from . import benchmarks as bench
from . import matrices, system, ui
from .args import ALWAYS, ArgError, Argument, Registry, typed_parser

S32_MAX = 2**31 - 1


class Config:
    input_path: str = ""
    output_path: str = ""
    matrix: matrices.SubstitutionMatrix | None = None
    algo: str = ""  # nw | ga | sw
    algo_gap_kind: str = ""  # linear | affine
    gap_pen: int = 0
    gap_opn: int = 0
    gap_ext: int = 0
    filter_threshold: float = 0.0
    compression: int = 0
    threads: int = 0
    no_device: bool = False  # -C
    no_write: bool = False  # -W
    checkpoint: str = ""  # -k (not yet ported)
    trace_dir: str = ""  # -t (not yet ported)


ALGOS = {
    "nw": ("Needleman-Wunsch", "linear"),
    "ga": ("Gotoh", "affine"),
    "sw": ("Smith-Waterman", "affine"),
}
ALIASES = {
    "needleman-wunsch": "nw",
    "nw": "nw",
    "gotoh": "ga",
    "ga": "ga",
    "smith-waterman": "sw",
    "sw": "sw",
}


def build_registry(cfg: Config) -> Registry:
    reg = Registry()

    # ---- input/output ---------------------------------------------------
    def validate_input():
        if not Path(cfg.input_path).is_file():
            raise ArgError("File not found")

    def parse_input(s):
        cfg.input_path = s
        return s

    reg.register(
        Argument(
            name="input_path", opt="i", lopt="input", param="FILE", required=True,
            help="Input file path: FASTA, DSV (.csv, .tsv, etc.)",
            parse=parse_input, validate=validate_input,
            action=lambda: ui.pinfo("Input: %s", Path(cfg.input_path).name),
            action_phase=ALWAYS,
        )
    )

    def validate_output():
        if cfg.no_write:
            return
        p = Path(cfg.output_path)
        if p.is_file():
            ui.pwarn("Output file already exists: %s", p.name)
            if not ui.print_yN("Do you want to DELETE it?"):
                raise ArgError("Output file exists and will not be overwritten")
            try:
                p.unlink()
            except OSError:
                raise ArgError("Failed to delete existing output file")
            ui.pinfo("Deleted existing output file")
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
        except OSError:
            raise ArgError("Failed to create directories for output file")

    def parse_output(s):
        cfg.output_path = s
        return s

    def print_output():
        if cfg.no_write:
            ui.pwarnm("Output: Ignored")
        else:
            ui.pinfom("Output: %s", Path(cfg.output_path).name)

    reg.register(
        Argument(
            name="output_path", opt="o", lopt="output", param="FILE", required=True,
            help="Output file path: HDF5 format",
            parse=parse_output, validate=validate_output,
            after=("input_path",), action=print_output,
            conflicts=("disable_write",),
        )
    )

    # ---- matrices --------------------------------------------------------
    def parse_list(_s=None):
        sys.stdout.write(matrices.grouped_listing())
        raise SystemExit(0)

    reg.register(
        Argument(
            name="list_matrices", opt="l", lopt="list-matrices",
            help="List available substitution matrices", parse=None,
        )
    )

    def parse_matrix(s):
        try:
            cfg.matrix = matrices.get(s)
        except KeyError:
            raise ArgError("Invalid substitution matrix name")
        return cfg.matrix.name

    reg.register(
        Argument(
            name="substitution_matrix", opt="m", lopt="matrix", param="MATRIX",
            required=True,
            help="Substitution matrix\n  Use -l, --list-matrices to see all available matrices",
            parse=parse_matrix, after=("output_path",),
            action=lambda: ui.pinfom("Matrix: %s", cfg.matrix.name),
        )
    )

    # ---- alignment method + gaps ----------------------------------------
    def parse_align(s):
        key = ALIASES.get(s.lower())
        if key is None:
            raise ArgError("Invalid alignment method")
        cfg.algo = key
        cfg.algo_gap_kind = ALGOS[key][1]
        return key

    def validate_align():
        # Gotoh with equal open/extend degenerates to NW (ga.c:70-88).
        if cfg.algo == "ga" and cfg.gap_opn == cfg.gap_ext:
            if ui.print_Yn("Equal affine gaps found, switch to Needleman-Wunsch?"):
                cfg.gap_pen = cfg.gap_opn
                cfg.gap_opn = cfg.gap_ext = 0
                cfg.algo = "nw"
                cfg.algo_gap_kind = "linear"

    methods_help = "Alignment method\n" + "".join(
        f"  {long}: {short}\n" for short, (long, _) in ALGOS.items()
    )
    reg.register(
        Argument(
            name="align", opt="a", lopt="align", param="METHOD", required=True,
            help=methods_help, parse=parse_align, validate=validate_align,
            after=("substitution_matrix",),
            # The GA->NW degenerate-gap switch must run after the gap
            # validators (reference validate DAG: align after gap_penalty,
            # gap_penalty after gap_open).
            validate_after=("gap_penalty", "gap_open", "gap_extend"),
            action=lambda: ui.pinfom("Method: %s", ALGOS[cfg.algo][0]),
        )
    )

    gap_parse = typed_parser(int, lambda v: 0 <= v <= S32_MAX, "Gap values must be positive integers")

    def parse_gap_pen(s):
        cfg.gap_pen = -gap_parse(s)  # stored negated (align.c:127-128)
        return cfg.gap_pen

    def parse_gap_opn(s):
        cfg.gap_opn = -gap_parse(s)
        return cfg.gap_opn

    def parse_gap_ext(s):
        cfg.gap_ext = -gap_parse(s)
        return cfg.gap_ext

    def validate_gap_pen():
        if cfg.algo_gap_kind != "linear":
            raise ArgError("Gap penalty cannot be set for non-linear methods")

    def validate_gap_affine():
        if cfg.algo_gap_kind != "affine":
            raise ArgError("Affine gaps cannot be set for non-affine methods")

    def print_gaps():
        if cfg.algo_gap_kind == "linear":
            ui.pinfom("Gap penalty: %d", cfg.gap_pen)
        else:
            ui.pinfom("Gap open: %d, extend: %d", cfg.gap_opn, cfg.gap_ext)

    reg.register(
        Argument(
            name="gap_penalty", opt="p", lopt="gap-penalty", param="N", required=True,
            help="Linear gap penalty", parse=parse_gap_pen, validate=validate_gap_pen,
            after=("align",), action=print_gaps,
            depends=("align",), conflicts=("gap_open", "gap_extend"),
        )
    )
    reg.register(
        Argument(
            name="gap_open", opt="s", lopt="gap-open", param="N", required=True,
            help="Affine gap open penalty", parse=parse_gap_opn,
            validate=validate_gap_affine, after=("substitution_matrix",),
            depends=("align",), conflicts=("gap_penalty",),
        )
    )
    reg.register(
        Argument(
            name="gap_extend", opt="e", lopt="gap-extend", param="N", required=True,
            help="Affine gap extend penalty", parse=parse_gap_ext,
            depends=("align",), conflicts=("gap_penalty",),
        )
    )

    # ---- filter / compression -------------------------------------------
    filt_parse = typed_parser(float, lambda v: 0.0 <= v <= 1.0,
                              "Filter threshold must be between 0.0 and 1.0")

    def parse_filter(s):
        cfg.filter_threshold = filt_parse(s)
        return cfg.filter_threshold

    def print_filter():
        if cfg.filter_threshold > 0.0:
            ui.pinfom("Filter threshold: %.1f%%", cfg.filter_threshold * 100.0)
        else:
            ui.pwarnm("Filter: Ignored")

    reg.register(
        Argument(
            name="filter_threshold", opt="f", lopt="filter", param="FLOAT",
            help="Filter sequences with similarity above threshold [0.0-1.0]",
            parse=parse_filter, after=("gap_penalty",), action=print_filter,
            action_phase="if_set",
        )
    )

    comp_parse = typed_parser(int, lambda v: 0 <= v <= 9,
                              "Compression level must be between 0-9")

    def parse_compression(s):
        cfg.compression = comp_parse(s)
        return cfg.compression

    reg.register(
        Argument(
            name="compression", opt="z", lopt="compression", param="N",
            help="Compression level for HDF5 datasets [0-9]",
            parse=parse_compression, depends=("output_path",),
            after=("filter_threshold",),
            action=lambda: ui.pinfom("Compression: %d", cfg.compression),
            action_phase="if_set",
        )
    )

    def parse_checkpoint(s):
        cfg.checkpoint = s
        return s

    reg.register(
        Argument(
            name="checkpoint", opt="k", lopt="checkpoint", param="FILE",
            help="Checkpoint file: resume an interrupted run by pair-block",
            parse=parse_checkpoint, after=("compression",),
            action=lambda: ui.pinfom("Checkpoint: %s", cfg.checkpoint),
            action_phase="if_set", conflicts=("disable_write",),
        )
    )

    def parse_trace(s):
        cfg.trace_dir = s
        return s

    reg.register(
        Argument(
            name="trace", opt="t", lopt="trace", param="DIR",
            help="Write a profiler trace of the alignment phase to DIR (not yet ported)",
            parse=parse_trace,
            action=lambda: ui.pinfom("Profiler trace: %s", cfg.trace_dir),
            action_phase="if_set",
        )
    )

    # ---- runtime knobs ---------------------------------------------------
    reg.register(
        Argument(
            name="benchmark", opt="B", lopt="benchmark",
            help="Enable timing of various steps",
            after=("compression",),
            action=lambda: ui.pinfo("Benchmarking mode: Enabled"),
            action_phase="if_set",
        )
    )

    thr_parse = typed_parser(int, lambda v: 0 <= v <= system.THREAD_MAX,
                             "Invalid thread count")

    def parse_threads(s):
        cfg.threads = thr_parse(s)
        return cfg.threads

    reg.register(
        Argument(
            name="threads", opt="T", lopt="threads", param="N",
            help="Number of HOST threads (0 = auto)\n"
                 "  Governs native host ops (parsing, store scatter, HDF5\n"
                 "  conversion); device compute parallelism comes from the\n"
                 "  GPU, not this flag",
            parse=parse_threads,
        )
    )
    reg.register(
        Argument(name="disable_device", opt="C", lopt="no-device",
                 help="Disable the CUDA device (run on the host CPU)")
    )
    reg.register(
        Argument(name="disable_write", opt="W", lopt="no-write",
                 help="Disable writing to output file")
    )
    reg.register(
        Argument(name="disable_progress", opt="P", lopt="no-progress",
                 help="Disable progress bars")
    )
    reg.register(
        Argument(name="no_detail", opt="D", lopt="no-detail",
                 help="Disable detailed printing")
    )
    reg.register(
        Argument(name="force", opt="F", lopt="force-proceed",
                 help="Force proceed without user prompts (for CI)")
    )
    reg.register(
        Argument(name="quiet", opt="Q", lopt="quiet",
                 help="Suppress all non-error printing")
    )
    reg.register(
        Argument(name="verbose", opt="V", lopt="verbose",
                 help="Enable verbose printing")
    )
    reg.register(
        Argument(name="help", opt="h", lopt="help", help="Display this help message")
    )
    return reg


#: Flags of the reference that the port does not run yet, with the ROADMAP
#: item that ports each.
NOT_PORTED = (
    ("filter_threshold", "-f", "A10"),
    ("checkpoint", "-k", "A11"),
    ("trace", "-t", "A14"),
)
#: Environment of a multi-host run (reference parallel/multihost.py).
MULTIHOST_ENV = ("SEQALIGN_TPU_COORDINATOR", "SEQALIGN_TPU_DISTRIBUTED")


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = Config()
    bench.enabled = False
    bench.reset()
    reg = build_registry(cfg)
    prog = Path(sys.argv[0]).name or "seqalign-torch"

    try:
        reg.parse(argv)
        # immediate-exit flags (parse-time actions in the reference)
        if reg.args["help"].is_set:
            sys.stdout.write(reg.help_text(prog))
            return 0
        if reg.args["list_matrices"].is_set:
            sys.stdout.write(matrices.grouped_listing())
            return 0
        ui.configure(
            quiet=reg.args["quiet"].is_set,
            verbose=reg.args["verbose"].is_set,
            no_detail=reg.args["no_detail"].is_set,
            force=reg.args["force"].is_set,
            no_progress=reg.args["disable_progress"].is_set,
        )
        cfg.no_write = reg.args["disable_write"].is_set
        cfg.no_device = reg.args["disable_device"].is_set
        bench.enabled = reg.args["benchmark"].is_set
        reg.validate()
    except ArgError as e:
        ui.perr(str(e))
        ui.pinfo("Use %s -h, --help for usage information", prog)
        return 1
    for name, flag, item in NOT_PORTED:
        if reg.args[name].is_set:
            ui.perr("%s is not yet ported (ROADMAP %s)", flag, item)
            return 1
    if any(os.environ.get(v) for v in MULTIHOST_ENV):
        ui.perr("Multi-host runs are not yet ported (ROADMAP A13)")
        return 1

    system.set_threads(cfg.threads)

    ui.pheader("SEQUENCE ALIGNER")
    ui.psection("Configuration")
    reg.actions()

    from .engine import Engine
    from .io import hdf5_io
    from .io import input as sio
    from .io.output import OutputStore, alignments

    ui.psection("Reading Dataset")
    try:
        with bench.phase("input"):
            ss = sio.load(cfg.input_path, cfg.matrix.lut, gap_pen=cfg.gap_pen)
        avg = float(ss.lengths.mean()) if ss.num else 0.0
        ui.pinfo("Loaded %d sequences", ss.num)
        ui.pinfol("Average sequence length: %.2f", avg)
        bench.phase_print("input")
    except (sio.ParseError, RuntimeError) as e:
        # RuntimeError: an interactive prompt (e.g. the DSV column chooser)
        # could not be answered — stdin pipe exhausted or invalid answer.
        ui.perr(str(e))
        return 1

    store = None
    if not cfg.no_write:
        ui.psection("Preparing Similarity Matrix")
        with bench.phase("output"):
            # Same stable length sort as Schedule.build: a spilling store
            # lays the packed triangle out in sorted coordinates.
            import numpy as np

            perm = np.argsort(ss.lengths, kind="stable")
            store = OutputStore.plan(ss.num, perm=perm)
    ui.psection("Performing Alignments")
    import torch

    if not cfg.no_device and not torch.cuda.is_available():
        ui.perr("No CUDA device found (use -C to run on the CPU)")
        return 1
    gaps = (cfg.gap_pen, cfg.gap_opn, cfg.gap_ext)
    engine = Engine(
        cfg.algo, cfg.matrix.matrix, gaps,
        device="cpu" if cfg.no_device else "cuda",
    )
    with bench.phase("align"):
        stats = engine.align_all(
            ss, store, progress=not reg.args["disable_progress"].is_set
        )
    bench.note_cells(stats.cells)
    bench.phase_print("align")

    if not cfg.no_write:
        ui.psection("Writing Output")
        with bench.phase("output"):
            hdf5_io.write(
                cfg.output_path, store, ss, compression=cfg.compression,
                progress=not reg.args["disable_progress"].is_set,
            )
        bench.phase_print("output")

    bench.total_print(alignments(ss.num))
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
