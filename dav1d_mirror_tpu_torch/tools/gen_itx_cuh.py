"""Generate ``csrc/itx_1d.cuh``: the 1-D inverse transforms of
``ops/itx_1d.py`` as straight-line CUDA device functions.

    python3 -m dav1d_mirror_tpu_torch.tools.gen_itx_cuh [--check]

``ops/itx_1d.py`` runs on anything with +, -, *, >> and ``.clip``. This
script runs each of its functions once on symbolic values (``Sym``),
which record every operation instead of computing it, and writes the
recorded program as C: one device function per (family, length) pair that
``ops/itx.itx_families`` allows, and one for ``iwht4``. The kernel's
arithmetic is so, by construction, the sequence of operations that the
plain PyTorch path (and the JAX package) runs. Operations that no output
depends on are dropped. ``--check`` compares the committed header with
what the script would write and exits non-zero if they differ.

Every +, -, * and unary - wraps as int32 two's complement does (torch,
numpy and XLA do that); the header does them in ``uint32_t`` because a
signed overflow is undefined in C++. ``>>`` is arithmetic on int32.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

from ..ops.itx import itx_families
from ..ops.itx_1d import get_1d_fn, iwht4

HEADER = os.path.join(os.path.dirname(__file__), os.pardir, "csrc",
                      "itx_1d.cuh")
# (family, line length); "wht" is the lossless 4-point Walsh-Hadamard
PAIRS = tuple((f, n) for n in (4, 8, 16, 32, 64)
              for f in itx_families(n)) + (("wht", 4),)


class Sym:
    """A value of a traced program: an input, an operation's result, or
    (as an argument) a Python int constant."""
    __slots__ = ("prog", "id")

    def __init__(self, prog, id_):
        self.prog = prog
        self.id = id_

    def _op(self, op, *args):
        return self.prog.emit(op, *args)

    def __add__(self, o):
        return self._op("add", self, o)

    def __radd__(self, o):
        return self._op("add", o, self)

    def __sub__(self, o):
        return self._op("sub", self, o)

    def __rsub__(self, o):
        return self._op("sub", o, self)

    def __mul__(self, o):
        if not isinstance(o, int):
            raise TypeError("only products with a constant are traced")
        return self._op("mul", self, o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __neg__(self):
        return self._op("neg", self)

    def __rshift__(self, k):
        if not isinstance(k, int):
            raise TypeError("only shifts by a constant are traced")
        return self._op("shr", self, k)

    def clip(self, mn, mx):
        assert (mn, mx) == ("mn", "mx"), (mn, mx)
        return self._op("clip", self)


class Program:
    """A straight-line program: values 0 .. n_in - 1 are its inputs, value
    n_in + i is the result of ops[i] = (op, args), each argument ("v",
    value id) or ("c", constant); outputs are value ids."""

    def __init__(self, n_in):
        self.n_in = n_in
        self.ops = []          # (op, args); value id = n_in + index
        self.outputs = []

    def inputs(self):
        return [Sym(self, k) for k in range(self.n_in)]

    def emit(self, op, *args):
        enc = []
        for a in args:
            if isinstance(a, Sym):
                enc.append(("v", a.id))
            elif isinstance(a, int):
                enc.append(("c", a))
            else:
                raise TypeError(f"cannot trace {type(a).__name__}")
        self.ops.append((op, tuple(enc)))
        return Sym(self, self.n_in + len(self.ops) - 1)


def trace(family: str, n: int) -> Program:
    """The program of one (family, n) pair, dead operations dropped and
    value ids renumbered in order."""
    n_in = min(n, 32)
    prog = Program(n_in)
    if family == "wht":
        outs = iwht4(prog.inputs())
    else:
        outs = get_1d_fn(family, n)(prog.inputs(), "mn", "mx")
    assert len(outs) == n, (family, n, len(outs))
    # dead-code elimination, then renumbering
    live = set(o.id for o in outs)
    for idx in range(len(prog.ops) - 1, -1, -1):
        if prog.n_in + idx in live:
            live.update(a[1] for a in prog.ops[idx][1] if a[0] == "v")
    new_id = {k: k for k in range(n_in)}
    out = Program(n_in)
    for idx, (op, args) in enumerate(prog.ops):
        if prog.n_in + idx not in live:
            continue
        new_id[prog.n_in + idx] = n_in + len(out.ops)
        out.ops.append((op, tuple(("v", new_id[a[1]]) if a[0] == "v" else a
                                  for a in args)))
    out.outputs = [new_id[o.id] for o in outs]
    return out


@functools.lru_cache(maxsize=None)
def op_count(family: str, n: int) -> int:
    """Arithmetic operations of one line of the pair (loads and stores
    not counted; a clip counts as one)."""
    return len(trace(family, n).ops)


def fn_name(family: str, n: int) -> str:
    return f"itx_{family}_{n}"


def _arg(a):
    return f"v{a[1]}" if a[0] == "v" else str(a[1])


def render_fn(family: str, n: int) -> str:
    p = trace(family, n)
    sig = (f"__device__ __forceinline__ void {fn_name(family, n)}("
           f"const int32_t* in, int32_t* out, int32_t mn, int32_t mx)")
    lines = [f"// {family}, {p.n_in} inputs, {n} outputs, {len(p.ops)} "
             f"operations", sig + " {"]
    lines += [f"    const int32_t v{k} = in[{k}];" for k in range(p.n_in)]
    for idx, (op, args) in enumerate(p.ops):
        call = ", ".join([_arg(a) for a in args] +
                         (["mn", "mx"] if op == "clip" else []))
        lines.append(
            f"    const int32_t v{p.n_in + idx} = itx_{op}({call});")
    lines += [f"    out[{k}] = v{v};" for k, v in enumerate(p.outputs)]
    lines.append("}")
    return "\n".join(lines)


PRELUDE = """\
// Generated by dav1d_mirror_tpu_torch/tools/gen_itx_cuh.py from
// dav1d_mirror_tpu_torch/ops/itx_1d.py; do not edit. Regenerate with
//     python3 -m dav1d_mirror_tpu_torch.tools.gen_itx_cuh
//
// The 1-D inverse transforms as straight-line device functions, one per
// (family, line length) of ops/itx.itx_families and one for iwht4:
// in[] holds min(n, 32) inputs, out[] receives n outputs, and every
// butterfly that clips clips to [mn, mx]. +, -, * and unary - wrap as
// int32 two's complement (done in uint32_t: a signed overflow is undefined
// in C++); >> is arithmetic.
#pragma once
#include <stdint.h>

__device__ __forceinline__ int32_t itx_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_neg(int32_t a) {
    return (int32_t)(0u - (uint32_t)a);
}
__device__ __forceinline__ int32_t itx_shr(int32_t a, int k) {
    return a >> k;
}
__device__ __forceinline__ int32_t itx_clip(int32_t a, int32_t mn,
                                            int32_t mx) {
    return min(max(a, mn), mx);
}
"""


def render_line(n: int) -> str:
    """The dispatch of one line length: family index i of
    ops/itx.itx_families(n) runs that family; any other index runs
    family 0, so a bad selector reads nothing out of bounds."""
    fams = itx_families(n)
    lines = [f"// family index i of itx_families({n}) = {fams}; any other "
             "index runs family 0",
             f"__device__ __forceinline__ void itx_line_{n}(int fam, "
             "const int32_t* in, int32_t* out,",
             "                                              int32_t mn, "
             "int32_t mx) {",
             "    switch (fam) {"]
    for i, f in enumerate(fams[1:], 1):
        lines.append(f"    case {i}: {fn_name(f, n)}(in, out, mn, mx); "
                     "break;")
    lines += [f"    default: {fn_name(fams[0], n)}(in, out, mn, mx); break;",
              "    }", "}"]
    return "\n".join(lines)


def render() -> str:
    return PRELUDE + "\n" + "\n\n".join(
        [render_fn(f, n) for f, n in PAIRS] +
        [render_line(n) for n in (4, 8, 16, 32, 64)]) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the committed header, write nothing")
    opts = ap.parse_args(argv)
    text = render()
    if opts.check:
        with open(HEADER) as f:
            same = f.read() == text
        print("csrc/itx_1d.cuh is " + ("up to date" if same else "STALE"))
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {os.path.normpath(HEADER)}: {len(PAIRS)} functions, "
          f"{sum(op_count(f, n) for f, n in PAIRS)} operations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
