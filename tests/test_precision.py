"""Matrix-product precision on the paths where it decides accuracy.

A GPU runs a default-precision f32 matmul in TF32 (10-bit input mantissa),
and the HIGH setting is TF32 there too. PME charge spreading and the CMAP
patch contractions therefore pin Precision.HIGHEST on every dot_general,
forward and in the gradient that gives the forces."""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from atomsmm_tpu.ops import cmap, pme

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs
    (scan/cond/custom_jvp bodies) included."""
    out = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _water_like(n=48, seed=0):
    rs = np.random.RandomState(seed)
    box = jnp.asarray([1.6, 1.6, 1.6])
    x = jnp.asarray(rs.uniform(0.0, 1.6, (n, 3)))
    q = jnp.asarray(rs.uniform(-0.8, 0.8, n))
    return x, box, q


GRID, ORDER, BLOCK, PAD = (8, 8, 8), 4, (4, 4, 4), 1


def _spread_dense(x, box, q):
    return pme.spread_charges(x, box, q, GRID, ORDER, chunk=16)


def _spread_blocked(x, box, q):
    return pme.spread_charges_blocked(x, box, q, GRID, ORDER, BLOCK, cap=48)


def _spread_stale(x, box, q):
    bucket, _ = pme.build_spread_bucket(x, box, GRID, ORDER, BLOCK, 48)
    return pme.spread_charges_stale(x, box, q, GRID, ORDER, BLOCK, 48, PAD,
                                    bucket)


def _cmap(x, box, q):
    del box, q
    rs = np.random.RandomState(3)
    table = jnp.asarray(rs.normal(size=(1, 24, 24, 4)))
    idx5 = jnp.asarray([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], jnp.int32)
    return cmap.cmap_energy(x, idx5, jnp.zeros((2,), jnp.int32), table)


@pytest.mark.parametrize("fn", [_spread_dense, _spread_blocked,
                                _spread_stale, _cmap],
                         ids=["dense", "blocked", "stale", "cmap"])
def test_every_dot_general_is_highest(fn):
    x, box, q = _water_like()

    def energy(xx):
        return jnp.sum(fn(xx, box, q) ** 2)

    for traced in (jax.make_jaxpr(lambda xx: fn(xx, box, q))(x),
                   jax.make_jaxpr(jax.grad(energy))(x)):
        precs = _dot_precisions(traced)
        assert precs, "no matrix product traced"
        for p in precs:
            assert p is not None and all(pi == HIGHEST for pi in p), p
