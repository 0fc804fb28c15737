"""Global constants of the HMM-HMM search framework.

Behavioral parity targets: reference hh-suite v3.3.0 `src/hhdecl.h:27-68` and
default parameter values from `src/hhdecl.cpp:7-173`.  Values are data (the
interchange/score contract), the code around them is TPU-native.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

# --- alphabet sizes and special residue codes (hhdecl.h:32-39) ---
NAA = 20          # amino acids 0..19
NTRANS = 7        # transitions per column: M2M,M2I,M2D,I2M,I2I,D2M,D2D
ANY = 20          # X / unknown residue
GAP = 21          # internal gap
ENDGAP = 22       # terminal gap (excluded from transition statistics)
NCOLMIN = 10      # min columns in subalignment for pos-specific weights
MAXENDGAPFRAC = 0.1
HMMSCALE = 1000   # fixed-point scale for log2 values in HHM files
MAXSEQDIS = 10238
MAXPROF = 32766
LAMDA = 0.388     # EVD lamda for -local score length correction
LAMDA_GLOB = 0.42
SELFEXCL = 3      # exclude self-alignment cells with |j-i| < SELFEXCL
PLTY_GAPOPEN = 6.0
PLTY_GAPEXTD = 1.0
MINCOLS_REALIGN = 6
POSTERIOR_PROBABILITY_THRESHOLD = 0.01
VITERBI_PATH_WIDTH = 40
FWD_BKW_PATHWIDTH = 40    # banded realign corridor around the Viterbi path

# secondary structure alphabets (hhdecl.h:53-55)
NDSSP = 8
NSSPRED = 4
MAXCF = 11

# transition index order (hhdecl.h:68)
M2M, M2I, M2D, I2M, I2I, D2M, D2D = range(7)
TRANS_NAMES = ("M2M", "M2I", "M2D", "I2M", "I2I", "D2M", "D2D")

# pair states used in backtraces (hhdecl.h:80)
STOP = 0
MM = 2
GD = 3
IM = 4
DG = 5
MI = 6

# --- amino acid order (hhdecl.h:57-66) ---
# internal order (index -> one-letter code)
AA_INTERNAL = "ARNDCQEGHILKMFPSTWYVX"
# alphabetical order used in HHM files
AA_ALPHA = "ACDEFGHIKLMNPQRSTVWYX"
# alphabetical index -> internal index
S2A = (0, 4, 3, 6, 13, 7, 8, 9, 11, 10, 12, 2, 14, 5, 1, 15, 16, 19, 17, 18, 20)
# internal index -> alphabetical index
A2S = (0, 14, 11, 2, 1, 13, 3, 5, 6, 7, 9, 8, 10, 4, 12, 15, 16, 18, 19, 17, 20)

# DSSP 8-state and PSIPRED 3-state alphabets (hhhmm/hhutil conventions)
# index 0 = '-' (no state available)
DSSP_CHARS = "-HEC~STG"   # see hhutil-inl.h ss2i/i2ss mapping
PSIPRED_CHARS = "-HEC"


# character -> internal code lookup (semantics of hhutil-inl.h:45-83 aa2i):
# residues 0-19, X/J/O -> ANY, U -> C, B -> D, Z -> E, -/./_ -> GAP,
# whitespace -> -1, anything else -> -2.
_AA2I = {}
for _i, _c in enumerate(AA_INTERNAL[:20]):
    _AA2I[_c] = _i
_AA2I.update({"X": ANY, "J": ANY, "O": ANY, "U": 4, "B": 3, "Z": 6,
              "-": GAP, ".": GAP, "_": GAP})


def aa2i(c: str) -> int:
    """One-letter amino-acid code -> internal index (hhutil-inl.h:45-83)."""
    v = _AA2I.get(c.upper())
    if v is not None:
        return v
    if ord(c) <= 32:
        return -1
    return -2


def i2aa(i: int) -> str:
    if 0 <= i < len(AA_INTERNAL):
        return AA_INTERNAL[i]
    if i == GAP or i == ENDGAP:
        return "-"
    return "X"


# --- default parameters (hhdecl.cpp:7-173) ---
@dataclasses.dataclass
class Parameters:
    """Runtime parameters; field names and defaults follow the reference
    `Parameters` struct (src/hhdecl.cpp:7-173) so CLI flags map 1:1."""

    maxcol: int = 32765
    maxres: int = 20001
    maxseq: int = 65535
    maxnumdb: int = 20000

    append: int = 0
    outformat: int = 0
    p: float = 20.0          # min probability for hit list
    E: float = 1e6           # max E-value for hit list
    b: int = 10              # min alignments shown
    B: int = 500             # max alignments shown
    z: int = 10              # min hit-list lines
    Z: int = 500             # max hit-list lines
    e: float = 1e-3          # max E-value for inclusion in output MSA
    realign_max: int = 500
    maxmem: float = 3.0
    showcons: int = 1
    showdssp: int = 1
    showpred: int = 1
    showconf: int = 0
    cons: int = 0
    nseqdis: int = 1
    mark: int = 0
    aliwidth: int = 80

    max_seqid: int = 90
    qid: int = 0
    qsc: float = -20.0
    coverage: int = 0
    Ndiff: int = 100
    allseqs: bool = False

    Neff: float = 0.0

    M: int = 1               # match-state assignment mode
    M_template: int = 1
    Mgaps: int = 50
    wg: int = 0              # 0: position-specific weights, 1: global

    matrix: int = 0          # 0: Gonnet

    # context pseudocount engines (hhdecl.cpp:52-62)
    pc_hhm_context_mode: int = 2        # HHsearchAdmix
    pc_hhm_context_a: float = 0.9
    pc_hhm_context_b: float = 4.0
    pc_hhm_context_c: float = 1.0
    pc_prefilter_context_mode: int = 3  # CSBlastAdmix
    pc_prefilter_context_a: float = 0.8
    pc_prefilter_context_b: float = 2.0
    pc_prefilter_context_c: float = 1.0
    pc_hhm_context_target_neff: float = 0.0
    pc_prefilter_context_target_neff: float = 0.0

    # nocontext pseudocounts (hhdecl.cpp:64-72)
    pc_hhm_nocontext_mode: int = 2
    pc_hhm_nocontext_a: float = 1.0
    pc_hhm_nocontext_b: float = 1.5
    pc_hhm_nocontext_c: float = 1.0
    pc_prefilter_nocontext_mode: int = 2
    pc_prefilter_nocontext_a: float = 1.0
    pc_prefilter_nocontext_b: float = 1.5
    pc_prefilter_nocontext_c: float = 1.0

    # transition pseudocounts (hhdecl.cpp:74-80)
    gapb: float = 1.0
    gapd: float = 0.15
    gape: float = 1.0
    gapf: float = 0.6
    gapg: float = 0.6
    gaph: float = 0.6
    gapi: float = 0.6

    ssm: int = 2
    ssw: float = 0.11
    ssw_realign: float = 0.11
    ssa: float = 1.0
    shift: float = -0.03
    mact: float = 0.3501
    corr: float = 0.1

    egq: float = 0.0
    egt: float = 0.0

    loc: int = 1             # 1: local alignment
    altali: int = 4
    smin: float = 20.0
    realign: int = 1
    premerge: int = 3
    columnscore: int = 1
    half_window_size_local_aa_bg_freqs: int = 40
    min_overlap: int = 0
    maxdbstrlen: int = 200
    indexfile: str = ""

    notags: int = 1
    hmmer_used: bool = False

    dbsize: int = 0
    alphaa: float = 0.4
    alphab: float = 0.02
    alphac: float = 0.1

    # db-alignment filter thresholds (mirrors of the plain ones,
    # hhdecl.cpp:129-135)
    max_seqid_db: int = 90
    qid_db: int = 0
    qsc_db: float = -20.0
    coverage_db: int = 0
    Ndiff_db: int = 100

    prefilter: bool = False
    early_stopping_filter: bool = False
    filter_thresh: float = 0.0

    prefilter_gap_open: int = 20
    prefilter_gap_extend: int = 4
    prefilter_score_offset: int = 50
    prefilter_bit_factor: int = 4
    prefilter_evalue_thresh: float = 1000.0
    prefilter_evalue_coarse_thresh: float = 100000.0
    preprefilter_smax_thresh: int = 10
    min_prefilter_hits: int = 100

    max_number_matrices: int = 100
    matrices_output_file: str = ""
    filter_matrices: bool = False

    csb: float = 0.85
    csw: float = 1.6
    clusterfile: str = ""
    cs_library: str = ""
    nocontxt: bool = False

    num_rounds: int = 2
    already_seen_filter: bool = True
    realign_old_hits: bool = False
    # TPU-native extension: -mesh N / -nomesh (0 = auto)
    mesh_devices: int = 0
    neffmax: float = 20.0
    threads: int = 2
    interim_filter: int = 1

    @classmethod
    def hhalign_defaults(cls, **kw) -> "Parameters":
        """HHalign::ProcessAllArguments overrides (hhalign.cpp:205-241)."""
        return cls(p=0.0, E=1e6, b=1, B=100, z=1, Z=100, altali=1,
                   realign=1, **kw)

    @classmethod
    def hhsearch_defaults(cls, **kw) -> "Parameters":
        """HHsearch::ProcessAllArguments (hhsearch.cpp:19-26)."""
        return cls(prefilter=False, num_rounds=1, **kw)

    @classmethod
    def hhblits_defaults(cls, **kw) -> "Parameters":
        """HHblits::ProcessAllArguments (hhblits.cpp:80-186)."""
        return cls(prefilter=True, early_stopping_filter=True,
                   filter_thresh=0.01, Ndiff=1000, **kw)

    infile: str = ""
    outfile: str = ""
    scorefile: str = ""
    m8file: str = ""
    alnfile: str = ""
    hhmfile: str = ""
    psifile: str = ""
    alitabfile: str = ""
    pairwisealisfile: str = ""
    alisbasename: str = ""
    tfiles: Optional[List[str]] = None
    exclstr: Optional[str] = None
    template_exclstr: Optional[str] = None
    argv: Optional[List[str]] = None
    v: int = 2                # verbosity, log.INFO (hhdecl.cpp:8)
