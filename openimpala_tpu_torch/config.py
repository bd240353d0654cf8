"""Inputs-file configuration (amrex::ParmParse compatible; the port's own
copy of ``openimpala_tpu/config.py`` plus the ``device`` key).

Parses the reference's key/value inputs files (``key = value  # comment``,
dotted namespaces like ``hypre.eps``, quoted strings, multi-token values —
see the schema in SURVEY.md §2.4 and ``Diffusion.cpp:200-223``) into a typed
config object.  Unlike the reference — which reads ParmParse deep inside
class constructors (``TortuosityHypre.cpp:147-151``) — all configuration is
resolved here once and threaded explicitly.
"""

from __future__ import annotations

import dataclasses
import shlex


class ParmParse:
    """Minimal amrex::ParmParse-style store: dotted keys -> token lists.

    Later definitions override earlier ones (ParmParse semantics); CLI
    overrides can be appended after file parsing.
    """

    def __init__(self):
        self._store: dict[str, list[str]] = {}

    @classmethod
    def from_file(cls, path: str, overrides=()):
        pp = cls()
        with open(path) as f:
            text = f.read()
        pp.parse_text(text)
        for ov in overrides:
            pp.parse_text(ov)
        return pp

    def parse_text(self, text: str):
        for raw_line in text.splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            try:
                tokens = shlex.split(val.strip())
            except ValueError:
                tokens = val.strip().split()
            if key:
                self._store[key] = tokens

    def query(self, key: str, default=None, type=str):
        if key not in self._store or not self._store[key]:
            return default
        tok = self._store[key][0]
        if type is bool:
            return tok.strip().lower() in ("1", "true", "yes", "on")
        return type(tok)

    def query_list(self, key: str, default=(), type=str):
        if key not in self._store:
            return list(default)
        return [type(t) for t in self._store[key]]

    def get(self, key: str, type=str):
        if key not in self._store:
            raise KeyError(f"required inputs key missing: {key}")
        return type(self._store[key][0])

    def __contains__(self, key):
        return key in self._store


@dataclasses.dataclass
class DiffusionConfig:
    """The configuration surface of the reference executable (``Diffusion.cpp:179-224``)."""

    filename: str
    data_path: str = "./data/"
    results_path: str = "./results_diffusion/"
    hdf5_dataset: str = "image"
    threshold_val: float = 0.5
    phase_id: int = 1
    solver_type: str = "FlexGMRES"
    # decomposition granularity (Diffusion.cpp:209 — AMReX max_grid_size);
    # the JAX package's distributed ingest reads it; the single-device port
    # parses it and has no use for it
    box_size: int = 32
    verbose: int = 1
    write_plotfile: bool = False
    calculation_method: str = "homogenization"
    output_filename: str = "results.txt"
    direction: str = "All"
    # tortuosity block (Diffusion.cpp:605-611, TortuosityHypre.cpp:147-157)
    tortuosity_vlo: float = -1.0
    tortuosity_vhi: float = 1.0
    tortuosity_remspot_passes: int = 0
    # per-component verbosity (TortuosityHypre.cpp:150-157 reads its own
    # "tortuosity.verbose"); -1 = inherit the global `verbose`
    tortuosity_verbose: int = -1
    # hypre block (TortuosityHypre.cpp:141-149)
    eps: float = 1e-9
    maxiter: int = 200
    # rev block (Diffusion.cpp:192-223)
    rev_do_study: bool = False
    rev_num_samples: int = 3
    rev_sizes: tuple = (32, 64, 96)
    rev_solver_type: str = "FlexGMRES"
    rev_results_file: str = "rev_study_Deff.csv"
    rev_write_plotfiles: bool = False
    rev_verbose: int = 1
    # "auto" | "true" | "false": vmap-batch same-shape crops (props/rev.py
    # _resolve_batch policy; auto decides per group by crop size)
    rev_batch: str = "auto"
    # raw-reader extras (no reference equivalent in the inputs surface:
    # the legacy raw example hard-codes dims; we expose them)
    raw_width: int = 0
    raw_height: int = 0
    raw_depth: int = 0
    raw_datatype: str = "UINT8"
    # per-axis voxel spacing (new surface; the reference CLI pins a unit
    # RealBox, Diffusion.cpp:302-305, but its kernels are dx-generic via
    # geom.CellSize() — imaging stacks routinely have Z spacing != XY).
    # One value = isotropic; three = (dx, dy, dz).  Anisotropic spacing
    # runs the same fused kernels via the per-axis packed geometry
    # (ops/stencil.py module comment).
    voxel_size: tuple = (1.0, 1.0, 1.0)
    # debug block (TortuosityHypre.cpp:543-544)
    debug_write_active_mask: bool = False
    # solver knobs (new surface)
    precond: str = "auto"
    krylov_maxiter: int = 20000
    inner_precision: str = "float32"  # or "float64"
    # where the port runs: "cuda" (default) or "cpu"; also a command-line
    # override, ``device=cpu``
    device: str = "cuda"

    @classmethod
    def from_parmparse(cls, pp: ParmParse) -> "DiffusionConfig":
        c = cls(filename=pp.get("filename"))
        c.data_path = pp.query("data_path", c.data_path)
        c.results_path = pp.query("results_path", pp.query("results_dir", c.results_path))
        c.hdf5_dataset = pp.query("hdf5_dataset", c.hdf5_dataset)
        c.threshold_val = pp.query("threshold_val", pp.query("threshold_value", c.threshold_val, float), float)
        c.phase_id = pp.query("phase_id", c.phase_id, int)
        c.solver_type = pp.query("solver_type", pp.query("solver", c.solver_type))
        c.box_size = pp.query("box_size", c.box_size, int)
        c.verbose = pp.query("verbose", c.verbose, int)
        c.write_plotfile = pp.query("write_plotfile", c.write_plotfile, bool)
        c.calculation_method = pp.query("calculation_method", c.calculation_method)
        c.output_filename = pp.query("output_filename", c.output_filename)
        c.direction = pp.query("direction", c.direction)
        c.tortuosity_vlo = pp.query("tortuosity.vlo", c.tortuosity_vlo, float)
        c.tortuosity_vhi = pp.query("tortuosity.vhi", c.tortuosity_vhi, float)
        c.tortuosity_remspot_passes = pp.query(
            "tortuosity.remspot_passes", c.tortuosity_remspot_passes, int
        )
        c.tortuosity_verbose = pp.query(
            "tortuosity.verbose", c.tortuosity_verbose, int
        )
        c.eps = pp.query("hypre.eps", c.eps, float)
        c.maxiter = pp.query("hypre.maxiter", c.maxiter, int)
        c.rev_do_study = pp.query("rev.do_study", c.rev_do_study, bool)
        c.rev_num_samples = pp.query("rev.num_samples", c.rev_num_samples, int)
        sizes = pp.query_list("rev.sizes", c.rev_sizes, int)
        c.rev_sizes = tuple(sizes)
        c.rev_solver_type = pp.query("rev.solver_type", c.rev_solver_type)
        c.rev_results_file = pp.query("rev.results_file", c.rev_results_file)
        c.rev_write_plotfiles = pp.query("rev.write_plotfiles", c.rev_write_plotfiles, bool)
        c.rev_verbose = pp.query("rev.verbose", c.rev_verbose, int)
        c.rev_batch = pp.query("rev.batch", c.rev_batch, str).strip().lower()
        if c.rev_batch not in ("auto", "true", "false", "1", "0", "yes",
                               "no", "on", "off"):
            raise ValueError(
                f"rev.batch must be auto/true/false, got {c.rev_batch!r}")
        # both spellings: the dotted native block and the underscore
        # forms the reference README documents (README.md:222)
        c.raw_width = pp.query("raw.width", pp.query("raw_width", c.raw_width, int), int)
        c.raw_height = pp.query("raw.height", pp.query("raw_height", c.raw_height, int), int)
        c.raw_depth = pp.query("raw.depth", pp.query("raw_depth", c.raw_depth, int), int)
        c.raw_datatype = pp.query("raw.datatype", pp.query("raw_datatype", c.raw_datatype))
        vs = pp.query_list("voxel_size", c.voxel_size, float)
        if len(vs) == 1:
            vs = vs * 3
        if len(vs) != 3 or any(v <= 0 for v in vs):
            raise ValueError(
                f"voxel_size takes 1 or 3 positive values, got {vs}")
        c.voxel_size = tuple(vs)
        c.debug_write_active_mask = pp.query(
            "debug.write_active_mask", c.debug_write_active_mask, bool
        )
        c.precond = pp.query("solver.precond", c.precond)
        c.krylov_maxiter = pp.query("solver.krylov_maxiter", c.krylov_maxiter, int)
        c.inner_precision = pp.query("solver.inner_precision", c.inner_precision)
        c.device = pp.query("device", c.device).strip().lower()
        # hypre.maxiter compatibility (TortuosityHypre.cpp:143): the
        # reference caps the preconditioned-FlexGMRES iteration count.  Our
        # analogue is the total Krylov budget across refinement rounds, so an
        # EXPLICIT hypre.maxiter becomes that budget unless the native
        # solver.krylov_maxiter key overrides it.  The defaults differ on
        # purpose (200 Hypre iterations vs 20000 float32 inner iterations —
        # a Jacobi-preconditioned run legitimately needs thousands).
        if "hypre.maxiter" in pp and "solver.krylov_maxiter" not in pp:
            c.krylov_maxiter = c.maxiter
        return c


# Solver-surface mapping: the reference accepts these names
# (stringToSolverType, Diffusion.cpp:45-58) but only implements FlexGMRES
# (TortuosityHypre.cpp:695-697).  We map each name onto our matrix-free
# solvers; names with no analogue raise with a clear message.
#
# The reference needs (Flex)GMRES because its identity-row formulation is
# non-symmetric; our eliminated free-set operator is SPD (ops/stencil.py),
# where CG solves the SAME system to the SAME ||r||/||b|| criterion with
# short recurrences — so the default "FlexGMRES" name gets CG (identical
# results, 1/20th the Krylov memory: a restart-20 FGMRES basis at 512^3 is
# ~11 GiB).  The explicit "GMRES"/"FGMRES" names keep the real restarted
# FGMRES implementation (solve/fgmres.py).
SOLVER_MAP = {
    "flexgmres": "cg",
    "gmres": "flexgmres",
    "fgmres": "flexgmres",
    "pcg": "cg",
    "cg": "cg",
    "jacobi": "cg",  # Jacobi-preconditioned CG is the closest SPD analogue
    "bicgstab": "cg",  # systems are SPD after elimination; CG is optimal
    "smg": "cg",  # SMG/PFMG are preconditioners here -> MG-preconditioned CG
    "pfmg": "cg",
}


def resolve_solver(name: str) -> str:
    key = name.strip().lower()
    if key not in SOLVER_MAP:
        raise ValueError(
            f"Invalid solver string: '{name}' (accepted: {sorted(SOLVER_MAP)})"
        )
    return SOLVER_MAP[key]


def solver_notice(name: str) -> str | None:
    """One-line runtime notice when a reference solver name maps onto a
    DIFFERENT algorithm here — so a user comparing console iteration counts
    against Hypre (TortuosityHypre.cpp:700-704) isn't silently misled.
    Returns None when the mapping is the identity (cg/pcg) or keeps the
    named algorithm (gmres/fgmres)."""
    key = name.strip().lower()
    if SOLVER_MAP.get(key) == "cg" and key not in ("cg", "pcg"):
        return (f"Note: solver_type={name} runs preconditioned CG on the SPD "
                f"eliminated system (iteration counts are not comparable "
                f"with Hypre {name} — see docs/MIGRATION.md, Solvers)")
    return None
