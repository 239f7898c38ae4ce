"""Distributed Schur-complement KKT solver for block-arrow systems.

TPU-native analogue of the reference's only distributed component — MPI-
parallel MUMPS over ScaLAPACK/BLACS (SURVEY.md §5.8) — redesigned for the
structure that actually arises at scale in this domain (SURVEY.md §2.15):
scenario/block-arrow KKT systems from multi-scenario stochastic NLPs,

    K = [ K_1          B_1 ]
        [     ...      ... ]
        [         K_S  B_S ]
        [ B_1^T .. B_S^T K_0 ],

with one scenario block per device.  Each K_s is factorized locally (dense
blocked LDL^T), the coupling Schur complement
S_0 = K_0 - sum_s B_s^T K_s^{-1} B_s is reduced with `psum` over the
device interconnect, and the back-substitution is local again.  The inertia of K is the sum of the
block inertias plus that of S_0 (Haynsworth), so the same inertia-corrected
regularization loop used by the IPM applies unchanged.

Entry points:
  schur_factor(Ks, Bs, K0)                -> SchurFactorization (+ inertia)
  schur_solve(fac, rhs_s, rhs0)           -> (x_s, x0)
  make_sharded_schur_solver(mesh, ...)    -> shard_map'ed factor+solve
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uno_tpu.linalg.ldlt import LDLT, ldlt_factor_blocked, ldlt_solve


class SchurFactorization(NamedTuple):
    block_fac: LDLT          # batched factorization of the K_s (S, nb, nb)
    Y: jnp.ndarray           # K_s^{-1} B_s (S, nb, n0)
    fac0: LDLT               # factorization of the Schur complement (n0, n0)
    num_pos: jnp.ndarray     # total inertia of K
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def schur_factor(Ks: jnp.ndarray, Bs: jnp.ndarray, K0: jnp.ndarray,
                 block: int = 32) -> SchurFactorization:
    """Single-program (vmapped) reference implementation."""
    facs = jax.vmap(lambda K: ldlt_factor_blocked(K, block=block))(Ks)
    Y = jax.vmap(ldlt_solve)(facs, Bs)                    # (S, nb, n0)
    contrib = jnp.einsum("sij,sik->jk", Bs, Y)            # sum_s B_s^T Y_s
    S0 = K0 - contrib
    fac0 = ldlt_factor_blocked(S0, block=block)
    return SchurFactorization(
        block_fac=facs, Y=Y, fac0=fac0,
        num_pos=jnp.sum(facs.num_pos) + fac0.num_pos,
        num_neg=jnp.sum(facs.num_neg) + fac0.num_neg,
        num_zero=jnp.sum(facs.num_zero) + fac0.num_zero,
    )


def schur_solve(fac: SchurFactorization, Bs: jnp.ndarray,
                rhs_s: jnp.ndarray, rhs0: jnp.ndarray):
    """Solve K [x_s; x0] = [rhs_s; rhs0] given a SchurFactorization."""
    r = jax.vmap(ldlt_solve)(fac.block_fac, rhs_s)        # K_s^{-1} rhs_s
    rhs_schur = rhs0 - jnp.einsum("sij,si->j", Bs, r)
    x0 = ldlt_solve(fac.fac0, rhs_schur)
    xs = r - jnp.einsum("sij,j->si", fac.Y, x0)
    return xs, x0


def make_sharded_schur_solver(mesh: Mesh, nb: int, n0: int,
                              axis: str = "scenario", block: int = 32):
    """Builds a shard_map'ed factor+solve over the mesh's scenario axis.

    Each device holds its scenario slice of (Ks, Bs, rhs_s); K_0 and rhs0 are
    replicated.  The Schur reduction is a `psum` over the devices.  Returns
    solve(Ks, Bs, K0, rhs_s, rhs0) -> (xs, x0, inertia_triple), jittable.
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def local(Ks, Bs, K0, rhs_s, rhs0):
        # Ks: (S/dev, nb, nb) local shard
        facs = jax.vmap(lambda K: ldlt_factor_blocked(K, block=block))(Ks)
        Y = jax.vmap(ldlt_solve)(facs, Bs)
        contrib = jnp.einsum("sij,sik->jk", Bs, Y)
        contrib = lax.psum(contrib, axis)                   # cross-device reduction
        S0 = K0 - contrib
        fac0 = ldlt_factor_blocked(S0, block=block)         # replicated factor
        r = jax.vmap(ldlt_solve)(facs, rhs_s)
        rhs_schur = rhs0 - lax.psum(jnp.einsum("sij,si->j", Bs, r), axis)
        x0 = ldlt_solve(fac0, rhs_schur)
        xs = r - jnp.einsum("sij,j->si", Y, x0)
        pos = lax.psum(jnp.sum(facs.num_pos), axis) + fac0.num_pos
        neg = lax.psum(jnp.sum(facs.num_neg), axis) + fac0.num_neg
        zero = lax.psum(jnp.sum(facs.num_zero), axis) + fac0.num_zero
        return xs, x0, pos, neg, zero

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(axis), P()),
        out_specs=(P(axis), P(), P(), P(), P()),
    )
    return jax.jit(sharded)


def random_block_arrow_system(S, nb, n0, seed=0, definite=True):
    """Test/bench generator: a symmetric block-arrow system with known
    structure (saddle blocks unless definite)."""
    rng = np.random.default_rng(seed)
    Ks = []
    for s in range(S):
        A = rng.standard_normal((nb, nb))
        K = (A + A.T) / 2 + (nb * np.eye(nb) if definite else 0.0)
        Ks.append(K)
    Bs = rng.standard_normal((S, nb, n0)) / np.sqrt(nb)
    A0 = rng.standard_normal((n0, n0))
    K0 = (A0 + A0.T) / 2 + (n0 + S) * np.eye(n0)
    return np.stack(Ks), Bs, K0


def dense_from_blocks(Ks, Bs, K0):
    S, nb, _ = Ks.shape
    n0 = K0.shape[0]
    N = S * nb + n0
    K = np.zeros((N, N))
    for s in range(S):
        K[s * nb:(s + 1) * nb, s * nb:(s + 1) * nb] = Ks[s]
        K[s * nb:(s + 1) * nb, S * nb:] = Bs[s]
        K[S * nb:, s * nb:(s + 1) * nb] = Bs[s].T
    K[S * nb:, S * nb:] = K0
    return K
