"""What a cold template build costs on this host: ``template_hmm_from_text``
then ``template_pc_stage`` (a3m to prepared template, what
``HHDatabase._prepared_cache_entry`` does on a miss) over a database's
a3m entries, hhsearch's defaults, the best of a few passes::

    python -m hhsuite_tpu_torch.tools.build_timing -d <db base> \\
        [-n 512] [-wg 1] [-passes 3]

``-n`` entries are taken evenly over the index; ``-wg`` is the global
weights flag (the search builds with 1, the realign stage with hhsearch's
``-wg`` default 0).  Run it from each of two trees to compare them: the
``digest`` (SHA-256 over every built template's arrays, Neff and display
rows, from one more pass) is equal where the two build the same bytes.
Prints, as its one line, a JSON object ``{"ms_a_build": ..., "passes":
[...], "n": ..., "wg": ..., "digest": ...}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

from ..constants import Parameters
from ..io.ffindex import FFindexDatabase
from ..matrices import get_substitution_matrix
from ..search.engine import template_hmm_from_text
from ..search.query import template_pc_stage

# what a prepared template holds that the search reads
ARRAYS = ("f", "g", "p", "tr", "Neff_M", "Neff_I", "Neff_D", "pav", "l",
          "ss_pred", "ss_conf", "ss_dssp", "sa_dssp")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-d", required=True, help="database base (<d>_a3m)")
    ap.add_argument("-n", type=int, default=512)
    ap.add_argument("-wg", type=int, default=1)
    ap.add_argument("-passes", type=int, default=3)
    args = ap.parse_args(argv)
    ff = FFindexDatabase(args.d + "_a3m.ffdata", args.d + "_a3m.ffindex")
    names = [e.name for e in ff.entries]
    names = names[:: max(1, len(names) // args.n)][: args.n]
    texts = [ff.read_text(n) for n in names]
    par = Parameters.hhsearch_defaults()
    mats = get_substitution_matrix(par.matrix)
    passes = []
    for _ in range(args.passes):
        t0 = time.perf_counter()
        for name, text in zip(names, texts):
            t, fmt = template_hmm_from_text(text, name, par, mats, args.wg)
            template_pc_stage(par, t, mats, fmt)
        passes.append(1e3 * (time.perf_counter() - t0) / len(names))
    h = hashlib.sha256()
    for name, text in zip(names, texts):
        t, fmt = template_hmm_from_text(text, name, par, mats, args.wg)
        template_pc_stage(par, t, mats, fmt)
        for a in ARRAYS:
            h.update(getattr(t, a).tobytes())
        h.update(repr((t.Neff_HMM, t.L, t.seq, t.sname, t.n_display,
                       t.nfirst, t.ncons)).encode())
    out = {"ms_a_build": min(passes), "passes": passes, "n": len(names),
           "wg": args.wg, "digest": h.hexdigest()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
