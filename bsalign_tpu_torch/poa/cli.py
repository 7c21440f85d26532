"""`bsalign-tpu-torch poa` — mirrors main_poa (main.c:387-557); port of
bsalign_tpu.poa.cli with the same flags and output, plus `--device
{cuda,cpu}`: where each realignment round's profile DP runs (`cuda`, the
default, raises without a CUDA device)."""
from __future__ import annotations

import argparse
import re
import sys

from .. import seqs as S
from ..constants import MODE_NAMES, parse_mode_list
from .core import BSPOA, BSPOAPar


_KV_RE = re.compile(r"([a-zA-Z_]+)=([.0-9]?)")


def _iter_kv(s):
    """Reproduce main.c's `([a-zA-Z_]+?)=([.0-9]+?)` + regexec loop: in
    glibc ERE the value group matches minimally (one char, or EMPTY when a
    non-digit like '-' follows '='), and atoi/atof then read from the
    position AFTER '=' regardless — which is how negative values such as
    editbw=-64 get through a digits-only pattern. Yields (name, tail) where
    tail is everything after '='; the scan resumes after the 0/1-char
    value, exactly like `str += mats[0].rm_eo`."""
    pos = 0
    while True:
        m = _KV_RE.search(s, pos)
        if not m:
            return
        yield m.group(1), s[m.end(1) + 1:]
        pos = m.end()


def _c_atoi(s: str) -> int:
    m = re.match(r"[ \t\n]*([+-]?[0-9]*)", s)
    t = m.group(1)
    return int(t) if t not in ("", "+", "-") else 0


def _c_atof(s: str) -> float:
    m = re.match(r"[ \t\n]*([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)"
                 r"(?:[eE][+-]?[0-9]+)?)", s)
    return float(m.group(1)) if m else 0.0


def default_poa_par() -> BSPOAPar:
    par = BSPOAPar()
    par.ksz = 13
    par.alnmode = MODE_NAMES["overlap"]
    par.M, par.X, par.O, par.E, par.Q, par.P, par.T = 2, -6, -3, -2, 0, 0, 20
    return par


def run_poa(argv):
    from ..cli import resolve_device
    ap = argparse.ArgumentParser(prog="bsalign-tpu-torch poa")
    ap.add_argument("-o", dest="cnsfn", default=None)
    # NOTE: usage text says [global] but main.c:400 leaves OVERLAP unless -m
    ap.add_argument("-m", default=None)
    ap.add_argument("-W", type=int, default=None)
    ap.add_argument("-M", default=None)
    ap.add_argument("-X", default=None)
    ap.add_argument("-O", default=None)
    ap.add_argument("-E", default=None)
    ap.add_argument("-Q", default=None)
    ap.add_argument("-P", default=None)
    ap.add_argument("-G", action="append", default=None)
    ap.add_argument("-T", action="append", default=None)
    ap.add_argument("-L", action="store_true")
    ap.add_argument("-C", action="store_true")
    ap.add_argument("-R", type=int, default=1)
    ap.add_argument("-v", action="count", default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    par = default_poa_par()
    if args.m:
        mname = parse_mode_list(args.m)
        if mname is None:
            sys.stderr.write("bad -m mode list\n")
            return 1
        par.alnmode = MODE_NAMES[mname]
    if args.W is not None:
        par.bandwidth = args.W
    for attr, val, neg in (("M", args.M, 1), ("X", args.X, -1),
                           ("O", args.O, -1), ("E", args.E, -1),
                           ("Q", args.Q, -1), ("P", args.P, -1)):
        if val is not None:
            setattr(par, attr, neg * int(val.split(",")[0]))
    msabeg, msaend, msacnt = 0, -1, 3
    t_seen = False
    if args.T:
        # debug triggers (main.c:477-490): msabeg/msaend/msacnt -> DOT dump;
        # rmabeg/rmaend parsed but unused upstream (remsa_lsps is if(0)'d)
        t_seen = True
        tvals = {"msabeg": msabeg, "msaend": msaend, "msacnt": msacnt,
                 "rmabeg": 0, "rmaend": -1}
        for opt in args.T:
            for tag, raw in _iter_kv(opt):
                for key in ("msabeg", "msaend", "msacnt", "rmabeg",
                            "rmaend"):
                    if key.startswith(tag.lower()):
                        tvals[key] = _c_atoi(raw)
                        break
                else:
                    sys.stderr.write(f"Unknown parameter: {opt}\n")
                    return 1
        msabeg, msaend, msacnt = (tvals["msabeg"], tvals["msaend"],
                                  tvals["msacnt"])
    if args.G:
        # main.c:445-477: ordered case-insensitive PREFIX dispatch over the
        # quirky `([a-zA-Z_]+?)=([.0-9]+?)` regex — the value group may
        # match empty and atoi/atof read PAST it, so negatives like
        # editbw=-64 do reach the engine (see _iter_kv)
        gkeys = (("psub", "f"), ("pins", "f"), ("pdel", "f"), ("piex", "f"),
                 ("pdex", "f"), ("hins", "f"), ("hdel", "f"),
                 ("nrec", "fi"), ("kmer", "i"), ("trigger", "fi"),
                 ("refmode", "i"), ("refbonus", "i"), ("realn", "i"),
                 ("editbw", "i"), ("althi", "i"), ("qlthi", "i"),
                 ("seqcore", "i"), ("shuffle", "i"), ("varcnt", "i"),
                 ("snvqlt", "i"), ("covfrq", "f"))
        attr_map = {"kmer": "ksz", "trigger": "bwtrigger",
                    "varcnt": "min_varcnt", "snvqlt": "min_snvqlt",
                    "covfrq": "min_covfrq"}
        for opt in args.G:
            for tag, raw in _iter_kv(opt):
                for key, typ in gkeys:
                    if key.startswith(tag.lower()):
                        if typ == "f":
                            val = _c_atof(raw)
                        elif typ == "fi":   # C assigns atof to an int field
                            val = int(_c_atof(raw))
                        else:
                            val = _c_atoi(raw)
                        setattr(par, attr_map.get(key, key), val)
                        break
                else:
                    sys.stderr.write(f"Unknown parameter: {opt}\n")
                    return 1
    g = BSPOA(par, device=device)
    g.beg()
    for path in args.inputs:
        for rec in S.read_fastx(path):
            if rec.seq:
                g.push(rec.seq)
    g.end()
    for _ in range(1, max(1, args.R)):   # -R benchmarking re-runs (main.c:521)
        g.keep_seqs = True
        g.beg()
        g.end()
    if args.cnsfn:
        with open(args.cnsfn, "w") as f:
            f.write(">cns_seq\n" + "".join("ACGTN-"[b] for b in g.cns) + "\n")
    g.tidy_msa()
    g.call_snvs()
    # main.c:478-492: case 'T' falls through into case 'L' (missing
    # break), so any -T also forces single-line MSA output
    mline = 0 if (args.L or t_seen) else 1
    g.print_msa("BSALIGN", sys.stdout, mline * 100, 1 if args.C else 0)
    g.print_snvs("BSALIGN", sys.stdout)
    if msaend >= msabeg:
        from .extras import print_dot
        with open("1.dot", "w") as f:
            print_dot(g, f, msabeg, msaend, msacnt)
    return 0
