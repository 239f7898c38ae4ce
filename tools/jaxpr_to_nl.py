#!/usr/bin/env python
"""Transcribe registry NLPs to AMPL .nl text by interpreting their jaxprs
with symbolic expression nodes (round-4 verdict item 1: give the parity
claim a reference-side denominator).

The registry's problems are vectorized JAX functions, not expression trees.
To run the REFERENCE binary (tools/baseline/uno_baseline + the postfix-AD
model from io/nlread.cpp) on the SAME corpus, each problem's objective and
constraint functions are traced to a jaxpr once (`jax.make_jaxpr`) and the
jaxpr is re-evaluated with numpy object-arrays of expression nodes (the E
DSL from tools/gen_nl_fixtures): every jax primitive either folds constants
(pure-float numpy ops) or builds E trees, and the result is emitted with
gen_nl_fixtures.write_nl in David Gay's public .nl text dialect — the same
dialect io/nlread.cpp parses (AMPLModel.cpp:19-41 reads it via ASL in the
reference).

Every emitted file is VERIFIED against the original problem before being
written: f/c are compared at x0 and at 3 perturbed points through the
io/nl.py JAX replayer (round-trip through the C++ parser).

Usage:
  python tools/jaxpr_to_nl.py [outdir] [--limit N] [--names a,b,c]
Writes <outdir>/<problem>.nl + a manifest json with per-problem status.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.setrecursionlimit(200000)

import jax  # noqa: E402

# switch to CPU BEFORE any backend initialization: the round-trip
# verification compares against numpy's transcendentals, so evaluations
# run on the host CPU, whatever accelerator is present
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from gen_nl_fixtures import E, write_nl  # noqa: E402  (same directory)

INF = float("inf")


# ---------------------------------------------------------------------------
# extra E helpers (gen_nl_fixtures defines sin/cos/exp)
# ---------------------------------------------------------------------------

def _w(x):
    return x if isinstance(x, E) else E("n", float(x))


def _un(op):
    def f(x):
        return E(op, _w(x))
    return f


_log = _un(43)
_sqrt = _un(39)
_tanh = _un(37)
_abs = _un(15)
_sin = _un(41)
_cos = _un(46)
_exp = _un(44)
_log10 = _un(42)
_sinh = _un(40)
_cosh = _un(45)
_tan = _un(38)
_atan = _un(49)
_asin = _un(51)
_acos = _un(53)


def _sumlist(terms):
    terms = [_w(t) for t in terms]
    if not terms:
        return E("n", 0.0)
    if len(terms) == 1:
        return terms[0]
    if len(terms) == 2:
        return terms[0] + terms[1]
    return E(54, *terms)


def _is_obj(a):
    return isinstance(a, np.ndarray) and a.dtype == object


def _map_unary(np_fn, e_fn, a):
    """Apply elementwise: constant-fold float arrays, build E trees else."""
    if not _is_obj(a):
        return np_fn(np.asarray(a, dtype=np.float64))
    return np.frompyfunc(
        lambda e: e_fn(e) if isinstance(e, E) else float(np_fn(e)), 1, 1)(a)


# ---------------------------------------------------------------------------
# jaxpr interpreter over object arrays
# ---------------------------------------------------------------------------

class Unsupported(Exception):
    pass


def _dot_general(eqn, a, b):
    ((lc, rc), (lb_, rb_)) = eqn.params["dimension_numbers"]
    if lb_ or rb_:
        raise Unsupported("dot_general with batch dims")
    a = np.asarray(a, dtype=object) if _is_obj(a) else np.asarray(a)
    b = np.asarray(b, dtype=object) if _is_obj(b) else np.asarray(b)
    # move contracted dims last/first and reshape to 2-D
    lfree = [i for i in range(a.ndim) if i not in lc]
    rfree = [i for i in range(b.ndim) if i not in rc]
    at = np.transpose(a, lfree + list(lc))
    bt = np.transpose(b, list(rc) + rfree)
    lsh = [a.shape[i] for i in lfree]
    rsh = [b.shape[i] for i in rfree]
    K = int(np.prod([a.shape[i] for i in lc], dtype=np.int64)) if lc else 1
    a2 = at.reshape((-1, K))
    b2 = bt.reshape((K, -1))
    if not (_is_obj(a2) or _is_obj(b2)):
        out = a2 @ b2
        return out.reshape(lsh + rsh)
    out = np.empty((a2.shape[0], b2.shape[1]), dtype=object)
    for i in range(a2.shape[0]):
        for j in range(b2.shape[1]):
            terms = []
            for k in range(K):
                x, y = a2[i, k], b2[k, j]
                if not isinstance(x, E) and float(x) == 0.0:
                    continue
                if not isinstance(y, E) and float(y) == 0.0:
                    continue
                if not isinstance(x, E) and not isinstance(y, E):
                    terms.append(float(x) * float(y))
                else:
                    # fold scalar-1 multiplications
                    if not isinstance(x, E) and float(x) == 1.0:
                        terms.append(y)
                    elif not isinstance(y, E) and float(y) == 1.0:
                        terms.append(x)
                    else:
                        terms.append(_w(x) * y if isinstance(y, E)
                                     else _w(y) * x)
            const = sum(t for t in terms if not isinstance(t, E))
            etx = [t for t in terms if isinstance(t, E)]
            if etx:
                s = _sumlist(etx)
                out[i, j] = s + const if const else s
            else:
                out[i, j] = float(const)
    return out.reshape(lsh + rsh)


def _reduce_sum(eqn, a):
    axes = eqn.params["axes"]
    if not _is_obj(a):
        return np.sum(np.asarray(a), axis=axes)
    # flatten reduced axes to the front, keep the rest
    keep = [i for i in range(a.ndim) if i not in axes]
    at = np.transpose(a, list(axes) + keep)
    ksh = [a.shape[i] for i in keep]
    a2 = at.reshape((-1,) + tuple(ksh)) if ksh else at.reshape(-1, 1)
    out = np.empty(tuple(ksh) if ksh else (1,), dtype=object).reshape(-1)
    flat = a2.reshape(a2.shape[0], -1)
    for j in range(flat.shape[1]):
        col = flat[:, j]
        const = sum(float(t) for t in col if not isinstance(t, E))
        etx = [t for t in col if isinstance(t, E)]
        if etx:
            s = _sumlist(etx)
            out[j] = s + const if const else s
        else:
            out[j] = const
    return out.reshape(tuple(ksh)) if ksh else out.reshape(())[()]


def _prod_tree(terms):
    # balanced o2 tree keeps emit/vars recursion depth at log n
    terms = list(terms)
    while len(terms) > 1:
        nxt = []
        for k in range(0, len(terms) - 1, 2):
            nxt.append(terms[k] * terms[k + 1])
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _reduce_prod(eqn, a):
    axes = eqn.params["axes"]
    if not _is_obj(a):
        return np.prod(np.asarray(a), axis=axes)
    if tuple(axes) != tuple(range(np.ndim(a))):
        raise Unsupported("partial reduce_prod")
    flat = a.reshape(-1)
    es = [t for t in flat]
    const = 1.0
    terms = []
    for t in es:
        if isinstance(t, E):
            terms.append(t)
        else:
            const *= float(t)
    if not terms:
        return np.float64(const)
    tree = _prod_tree([_w(t) for t in terms])
    return tree * const if const != 1.0 else tree


def _binop(fn):
    def impl(eqn, a, b):
        return fn(a, b)
    return impl


def _unimpl(name):
    def impl(eqn, *args):
        raise Unsupported(f"primitive {name}")
    return impl


def _conv(eqn, a):
    if _is_obj(a) or isinstance(a, E):
        return a
    return np.asarray(a, dtype=np.float64)


def _dynamic_slice(eqn, a, *starts):
    # static (literal) start indices only — library problems slice with
    # constants (z[-1] lowers to dynamic_slice with a literal start)
    s = []
    for st in starts:
        if _is_obj(st) or isinstance(st, E):
            raise Unsupported("dynamic_slice with traced start")
        s.append(int(np.asarray(st).reshape(()).item()))
    sizes = eqn.params["slice_sizes"]
    idx = tuple(np.s_[a0:a0 + sz] for a0, sz in zip(s, sizes))
    return np.asarray(a)[idx] if not _is_obj(a) else a[idx]


def _integer_pow(eqn, a):
    y = eqn.params["y"]
    if not _is_obj(a):
        return np.asarray(a, dtype=np.float64) ** y
    if y == 2:
        # o77 would need binary-parser parity; x*x keeps trees small anyway
        return np.frompyfunc(
            lambda e: (e * e) if isinstance(e, E) else float(e) ** 2,
            1, 1)(a)
    return np.frompyfunc(
        lambda e: (e ** float(y)) if isinstance(e, E) else float(e) ** y,
        1, 1)(a)


def _select_n(eqn, pred, *cases):
    if len(cases) != 2:
        raise Unsupported("select_n with >2 cases")
    if not _is_obj(pred) and not any(_is_obj(c) for c in cases):
        return np.where(np.asarray(pred, bool), cases[1], cases[0])
    pred_a = np.asarray(pred, dtype=object).reshape(-1) \
        if _is_obj(pred) else np.asarray(pred).reshape(-1)
    shp = np.broadcast_shapes(np.shape(pred),
                              *[np.shape(c) for c in cases])
    pb = np.broadcast_to(np.asarray(pred, dtype=object)
                         if _is_obj(pred) else np.asarray(pred), shp)
    cb = [np.broadcast_to(np.asarray(c, dtype=object)
                          if _is_obj(c) else np.asarray(c), shp)
          for c in cases]
    out = np.empty(shp, dtype=object)
    it = np.nditer(np.zeros(shp), flags=["multi_index"]) if shp else None
    idxs = [()] if not shp else [it.multi_index for _ in it] if False else \
        list(np.ndindex(*shp))
    for ix in idxs:
        p = pb[ix]
        f_, t_ = cb[0][ix], cb[1][ix]
        if isinstance(p, E) or isinstance(f_, E) or isinstance(t_, E):
            out[ix] = E(35, _w(p), _w(t_), _w(f_))
        else:
            out[ix] = float(t_) if p else float(f_)
    return out
    _ = pred_a


def _cmp(op):
    def impl(eqn, a, b):
        if not (_is_obj(a) or _is_obj(b)):
            return {22: np.less, 23: np.less_equal, 24: np.equal,
                    28: np.greater_equal, 29: np.greater,
                    30: np.not_equal}[op](a, b)
        shp = np.broadcast_shapes(np.shape(a), np.shape(b))
        ab = np.broadcast_to(np.asarray(a, dtype=object)
                             if _is_obj(a) else np.asarray(a), shp)
        bb = np.broadcast_to(np.asarray(b, dtype=object)
                             if _is_obj(b) else np.asarray(b), shp)
        out = np.empty(shp, dtype=object)
        for ix in np.ndindex(*shp) if shp else [()]:
            out[ix] = E(op, _w(ab[ix]), _w(bb[ix]))
        return out
    return impl


def _maxmin(np_fn, op):
    def impl(eqn, a, b):
        if not (_is_obj(a) or _is_obj(b)):
            return np_fn(a, b)
        shp = np.broadcast_shapes(np.shape(a), np.shape(b))
        ab = np.broadcast_to(np.asarray(a, dtype=object)
                             if _is_obj(a) else np.asarray(a), shp)
        bb = np.broadcast_to(np.asarray(b, dtype=object)
                             if _is_obj(b) else np.asarray(b), shp)
        out = np.empty(shp, dtype=object)
        for ix in np.ndindex(*shp) if shp else [()]:
            x, y = ab[ix], bb[ix]
            if isinstance(x, E) or isinstance(y, E):
                out[ix] = E(op, _w(x), _w(y))
            else:
                out[ix] = float(np_fn(x, y))
        return out
    return impl


PRIMS = {
    "add": _binop(lambda a, b: a + b),
    "sub": _binop(lambda a, b: a - b),
    "mul": _binop(lambda a, b: a * b),
    "div": _binop(lambda a, b: a / b),
    "pow": _binop(lambda a, b: a ** b),
    "neg": lambda eqn, a: -a if _is_obj(a) else -np.asarray(a),
    "exp": lambda eqn, a: _map_unary(np.exp, _exp, a),
    "log": lambda eqn, a: _map_unary(np.log, _log, a),
    "sin": lambda eqn, a: _map_unary(np.sin, _sin, a),
    "cos": lambda eqn, a: _map_unary(np.cos, _cos, a),
    "tan": lambda eqn, a: _map_unary(np.tan, _tan, a),
    "tanh": lambda eqn, a: _map_unary(np.tanh, _tanh, a),
    "sinh": lambda eqn, a: _map_unary(np.sinh, _sinh, a),
    "cosh": lambda eqn, a: _map_unary(np.cosh, _cosh, a),
    "atan": lambda eqn, a: _map_unary(np.arctan, _atan, a),
    "asin": lambda eqn, a: _map_unary(np.arcsin, _asin, a),
    "acos": lambda eqn, a: _map_unary(np.arccos, _acos, a),
    "sqrt": lambda eqn, a: _map_unary(np.sqrt, _sqrt, a),
    "abs": lambda eqn, a: _map_unary(np.abs, _abs, a),
    "log1p": lambda eqn, a: _map_unary(
        np.log1p, lambda e: _log(e + 1.0), a),
    "rsqrt": lambda eqn, a: _map_unary(
        lambda v: 1.0 / np.sqrt(v), lambda e: 1.0 / _sqrt(e), a),
    "integer_pow": _integer_pow,
    "reduce_sum": _reduce_sum,
    "reduce_prod": lambda eqn, a: _reduce_prod(eqn, a),
    "dot_general": _dot_general,
    "broadcast_in_dim": lambda eqn, a: np.broadcast_to(
        np.reshape(a, [d if i in eqn.params["broadcast_dimensions"] else 1
                       for i, d in enumerate(eqn.params["shape"])]
                   if np.ndim(a) else eqn.params["shape"] and
                   [1] * len(eqn.params["shape"])) if np.ndim(a) or
        eqn.params["shape"] else a, eqn.params["shape"]).copy()
    if eqn.params["shape"] else np.asarray(a),
    "reshape": lambda eqn, a: np.reshape(a, eqn.params["new_sizes"]),
    "squeeze": lambda eqn, a: np.squeeze(
        a, axis=tuple(eqn.params["dimensions"])),
    "expand_dims": lambda eqn, a: np.expand_dims(
        a, tuple(eqn.params["dimensions"])),
    "transpose": lambda eqn, a: np.transpose(a, eqn.params["permutation"]),
    "slice": lambda eqn, a: a[tuple(
        np.s_[s:e:st] for s, e, st in
        zip(eqn.params["start_indices"], eqn.params["limit_indices"],
            eqn.params["strides"] or [1] * np.ndim(a)))],
    "rev": lambda eqn, a: np.flip(a, axis=tuple(eqn.params["dimensions"])),
    "concatenate": lambda eqn, *xs: np.concatenate(
        [np.asarray(x, dtype=object) if any(_is_obj(y) for y in xs)
         else np.asarray(x) for x in xs], axis=eqn.params["dimension"]),
    "convert_element_type": _conv,
    "stop_gradient": lambda eqn, a: a,
    "copy": lambda eqn, a: a,
    "max": _maxmin(np.maximum, 12),
    "min": _maxmin(np.minimum, 11),
    "select_n": _select_n,
    "lt": _cmp(22),
    "ne": _cmp(30),
    "rem": _maxmin(np.fmod, 4),  # truncated remainder; o4 in ASL
    "atan2": _maxmin(np.arctan2, 48),
    "and": _maxmin(np.logical_and, 21),
    "or": _maxmin(np.logical_or, 20),
    "not": lambda eqn, a: _map_unary(np.logical_not, _un(34), a),
    "xor": _unimpl("xor"),
    "cumsum": lambda eqn, a: np.cumsum(
        np.asarray(a, dtype=object) if _is_obj(a) else np.asarray(a),
        axis=eqn.params["axis"]),
    "le": _cmp(23),
    "eq": _cmp(24),
    "ge": _cmp(28),
    "gt": _cmp(29),
    "iota": lambda eqn, *a: _iota(eqn),
    "gather": _unimpl("gather"),   # filled in below (static indices only)
    "dynamic_slice": None,         # filled in below (static starts only)
    # constant-fold only: ASL has no smooth sign; a traced sign raises
    "sign": lambda eqn, a: np.sign(np.asarray(a, dtype=np.float64))
    if not _is_obj(a) else _unimpl("sign (traced)")(eqn),
    "erf": _unimpl("erf"),
    "floor": lambda eqn, a: _map_unary(np.floor, _un(13), a),
    "ceil": lambda eqn, a: _map_unary(np.ceil, _un(14), a),
}


def _iota(eqn):
    shape = eqn.params["shape"]
    dim = eqn.params["dimension"]
    r = np.arange(shape[dim], dtype=np.float64)
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return np.broadcast_to(r.reshape(view), shape).copy()


def _pad(eqn, a, pv):
    cfg = eqn.params["padding_config"]
    if any(i != 0 for _, _, i in cfg):
        raise Unsupported("pad with interior dilation")
    if any(lo < 0 or hi < 0 for lo, hi, _ in cfg):
        raise Unsupported("pad with negative (cropping) config")
    pvv = pv.reshape(())[()] if isinstance(pv, np.ndarray) else pv
    if _is_obj(a) or isinstance(pvv, E):
        out = np.full([d + lo + hi for d, (lo, hi, _) in zip(a.shape, cfg)],
                      pvv, dtype=object)
    else:
        out = np.full([d + lo + hi for d, (lo, hi, _) in zip(np.shape(a), cfg)],
                      float(pvv), dtype=np.float64)
    sl = tuple(np.s_[lo:lo + d] for d, (lo, hi, _) in zip(np.shape(a), cfg))
    out[sl] = a
    return out


def _gather(eqn, a, idx):
    # static integer indices (library problems index with constant arrays);
    # replay through numpy's take along the gathered dims for the common
    # 1-D case x[idx]
    if _is_obj(idx):
        raise Unsupported("gather with traced indices")
    d = eqn.params["dimension_numbers"]
    r = np.ndim(a)
    # element gather: every operand dim is collapsed and indexed --
    # covers x[idx] (1-D) and A[i_k, j_k] (n-D pointwise selection)
    if (d.offset_dims == () and
            d.collapsed_slice_dims == tuple(range(r)) and
            d.start_index_map == tuple(range(r))):
        ia = np.asarray(idx, dtype=np.int64)
        batch_shape = ia.shape[:-1]
        flat = ia.reshape(-1, ia.shape[-1])
        base = np.asarray(a, dtype=object) if _is_obj(a) else np.asarray(a)
        picks = [base[tuple(row)] for row in flat]
        if any(isinstance(p, E) for p in picks):
            out = np.empty(len(picks), dtype=object)
            for k, p in enumerate(picks):
                out[k] = p
        else:
            out = np.asarray(picks, dtype=np.float64)
        return out.reshape(batch_shape)
    raise Unsupported("gather pattern")


PRIMS["gather"] = _gather
PRIMS["pad"] = _pad


def _scatter(eqn, operand, indices, updates, mode="set"):
    if _is_obj(indices):
        raise Unsupported("scatter with traced indices")
    d = eqn.params["dimension_numbers"]
    # library patterns: x.at[idx].set/add(upd) on a 1-D operand, and
    # grid.at[i].set(row) on an n-D operand (leading-dim row scatter)
    idx_nd = np.asarray(indices).ndim
    expect_window = tuple(range(idx_nd - 1,
                                idx_nd - 1 + np.ndim(operand) - 1))
    if (d.inserted_window_dims == (0,) and
            d.scatter_dims_to_operand_dims == (0,) and
            d.update_window_dims == expect_window):
        obj = _is_obj(operand) or _is_obj(updates) or isinstance(updates, E)
        out = np.asarray(operand, dtype=object).copy() if obj \
            else np.asarray(operand, dtype=np.float64).copy()
        flat_idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        if isinstance(updates, np.ndarray):
            upd = updates
        else:
            upd = np.empty(1, dtype=object)
            upd[0] = updates
        upd = upd.reshape((flat_idx.size,) + out.shape[1:])
        for k, i in enumerate(flat_idx):
            if i < 0 or i >= out.shape[0]:
                continue   # XLA drops out-of-bounds scatter updates
            if mode == "set":
                out[i] = upd[k]
            else:
                out[i] = out[i] + upd[k]
        return out
    raise Unsupported(
        f"scatter pattern {d} operand={np.shape(operand)} "
        f"indices={np.shape(indices)} updates={np.shape(updates)}")


PRIMS["scatter"] = lambda eqn, o, i, u: _scatter(eqn, o, i, u, "set")
PRIMS["scatter-add"] = lambda eqn, o, i, u: _scatter(eqn, o, i, u, "add")
PRIMS["scatter_add"] = lambda eqn, o, i, u: _scatter(eqn, o, i, u, "add")
PRIMS["dynamic_slice"] = _dynamic_slice


def interp_jaxpr(closed, *args):
    jaxpr = closed.jaxpr
    env = {}

    from jax.extend import core as jex_core
    Literal = jex_core.Literal

    def norm(val):
        if isinstance(val, E):
            arr = np.empty((), dtype=object)
            arr[()] = val
            return arr
        if isinstance(val, np.ndarray):
            return val
        return np.asarray(val, dtype=np.float64)

    def read(v):
        if isinstance(v, Literal):
            return np.asarray(v.val, dtype=np.float64) \
                if np.asarray(v.val).dtype != object else v.val
        return env[v]

    for v, c in zip(jaxpr.constvars, closed.consts):
        env[v] = np.asarray(c, dtype=np.float64)
    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("pjit", "jit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "remat", "checkpoint"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is None:
                raise Unsupported(f"{name} without inner jaxpr")
            if hasattr(inner, "jaxpr"):
                outs = interp_jaxpr(inner, *[read(v) for v in eqn.invars])
            else:
                from jax.extend.core import ClosedJaxpr  # type: ignore
                outs = interp_jaxpr(ClosedJaxpr(inner, ()),
                                    *[read(v) for v in eqn.invars])
            for v, o in zip(eqn.outvars, outs):
                env[v] = o
            continue
        impl = PRIMS.get(name)
        if impl is None:
            raise Unsupported(f"primitive {name}")
        invals = [read(v) for v in eqn.invars]
        out = impl(eqn, *invals)
        if eqn.primitive.multiple_results:
            for v, o in zip(eqn.outvars, out):
                env[v] = norm(o)
        else:
            env[eqn.outvars[0]] = norm(out)
    return [read(v) for v in jaxpr.outvars]


# ---------------------------------------------------------------------------
# problem -> .nl
# ---------------------------------------------------------------------------

def nlp_to_nl(nlp, path):
    """Trace nlp.objective / nlp.constraints, interpret with E nodes, write
    .nl text.  Raises Unsupported for programs using primitives outside the
    smooth ASL subset."""
    n = nlp.n
    xs = np.empty(n, dtype=object)
    from gen_nl_fixtures import V
    for i in range(n):
        xs[i] = V(i)

    def unwrap(v):
        if isinstance(v, np.ndarray):
            v = v.reshape(())[()]
        return _w(v)

    x_spec = jnp.zeros(n)
    f_jaxpr = jax.make_jaxpr(nlp.objective)(x_spec)
    obj_e = unwrap(interp_jaxpr(f_jaxpr, xs)[0])
    if nlp.m:
        c_jaxpr = jax.make_jaxpr(nlp.constraints)(x_spec)
        cons_arr = np.asarray(interp_jaxpr(c_jaxpr, xs)[0]).reshape(-1)
        cons = [unwrap(cons_arr[j]) for j in range(nlp.m)]
    else:
        cons = []

    # constant objective/constraint entries would emit empty-var G/J rows;
    # write_nl handles them (vars() just returns empty)
    write_nl(path, nlp.name, n, np.asarray(nlp.x0, dtype=np.float64),
             np.asarray(nlp.x_lb, dtype=np.float64),
             np.asarray(nlp.x_ub, dtype=np.float64),
             cons, obj_e,
             np.asarray(nlp.c_lb, dtype=np.float64) if nlp.m else np.zeros(0),
             np.asarray(nlp.c_ub, dtype=np.float64) if nlp.m else np.zeros(0))


def verify_roundtrip(nlp, path, rng):
    """Parse the emitted file back through io/nlread.cpp + io/nl.py and
    compare f/c at x0 and perturbed points."""
    from uno_tpu.io import read_nl
    back = read_nl(path)
    assert back.n == nlp.n and back.m == nlp.m, \
        f"shape mismatch {back.n}x{back.m} vs {nlp.n}x{nlp.m}"
    x0 = np.asarray(nlp.x0, dtype=np.float64)
    pts = [x0] + [x0 + 0.1 * rng.standard_normal(nlp.n) for _ in range(3)]
    for x in pts:
        xj = jnp.asarray(x)
        fa = float(nlp.objective(xj))
        fb = float(back.objective(xj))
        if not (np.isfinite(fa) and np.isfinite(fb)):
            continue
        assert abs(fa - fb) <= 1e-8 * max(1.0, abs(fa)), \
            f"objective mismatch {fa} vs {fb}"
        if nlp.m:
            ca = np.asarray(nlp.constraints(xj))
            cb = np.asarray(back.constraints(xj))
            mask = np.isfinite(ca) & np.isfinite(cb)
            assert np.max(np.abs(ca[mask] - cb[mask]), initial=0.0) <= \
                1e-8 * max(1.0, np.max(np.abs(ca[mask]), initial=1.0)), \
                "constraint mismatch"
    # bounds
    np.testing.assert_allclose(np.asarray(back.x_lb), np.asarray(nlp.x_lb))
    np.testing.assert_allclose(np.asarray(back.x_ub), np.asarray(nlp.x_ub))
    if nlp.m:
        np.testing.assert_allclose(np.asarray(back.c_lb),
                                   np.asarray(nlp.c_lb))
        np.testing.assert_allclose(np.asarray(back.c_ub),
                                   np.asarray(nlp.c_ub))


def main():
    argv = sys.argv[1:]
    outdir = "tests/fixtures/nl_corpus"
    names_filter = None
    limit = None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--limit":
            limit = int(argv[i + 1]); i += 2
        elif argv[i] == "--names":
            names_filter = argv[i + 1].split(","); i += 2
        else:
            rest.append(argv[i]); i += 1
    if rest:
        outdir = rest[0]
    os.makedirs(outdir, exist_ok=True)

    from uno_tpu.model.library import get_problem, problem_names, \
        known_optimum
    names = names_filter or [p for p in problem_names()
                             if not p.startswith("nl_")]
    if limit:
        names = names[:limit]
    rng = np.random.default_rng(0)
    manifest = {}
    ok = 0
    import signal

    class _Timeout(Exception):
        pass

    def _alarm(signum, frame):
        raise _Timeout()

    signal.signal(signal.SIGALRM, _alarm)
    resume = "--no-resume" not in sys.argv
    for name in names:
        path = os.path.join(outdir, f"{name}.nl")
        if resume and os.path.exists(path):
            nlp = get_problem(name)
            manifest[name] = {"status": "ok", "n": nlp.n, "m": nlp.m,
                              "f_star": known_optimum(name)}
            ok += 1
            continue
        try:
            # large dense problems (e.g. n=1000 all-pairs residuals) build
            # O(n^2) expression trees; bound the per-problem cost
            signal.alarm(240)
            nlp = get_problem(name)
            nlp_to_nl(nlp, path)
            verify_roundtrip(nlp, path, rng)
            fs = known_optimum(name)
            manifest[name] = {"status": "ok", "n": nlp.n, "m": nlp.m,
                              "f_star": fs}
            ok += 1
        except Unsupported as exc:
            manifest[name] = {"status": "unsupported", "reason": str(exc)}
            if os.path.exists(path):
                os.remove(path)
        except _Timeout:
            manifest[name] = {"status": "timeout",
                              "reason": "expression build > 240 s"}
            if os.path.exists(path):
                os.remove(path)
        except Exception as exc:  # noqa: BLE001 — record and continue
            manifest[name] = {"status": "error",
                              "reason": f"{type(exc).__name__}: {exc}"}
            if os.path.exists(path):
                os.remove(path)
        finally:
            signal.alarm(0)
        print(f"{name}: {manifest[name]['status']}"
              + ("" if manifest[name]["status"] == "ok"
                 else f" ({manifest[name].get('reason', '')[:90]})"),
              flush=True)
    with open(os.path.join(outdir, "manifest.json"), "w") as fh:
        json.dump({"emitted": ok, "total": len(names),
                   "problems": manifest}, fh, indent=1)
    print(f"\nemitted {ok}/{len(names)} -> {outdir}")


if __name__ == "__main__":
    main()
