"""The port's linear algebra (``paddle_tpu_torch.tensor.linalg`` and the
``paddle_tpu_torch.linalg`` namespace), random sampling and sequence ops
against the JAX package's on the CPU (``torch_op_parity``'s harness;
linear algebra within 1e-4 of each output's scale).

Factorizations whose factors are defined up to signs or phases (``svd``,
``qr``, ``eig``, ``eigh``) are compared through their reconstructions
and their sorted eigen- or singular values; their VJPs are compared on
the sign-free outputs (eigenvalues, singular values).  Random draws
cannot match JAX's bits: their shapes, dtypes, ranges and moments are
held to the JAX functions', and each draw is reproducible under
``paddle.seed`` and under an explicit generator.
"""
from torch_cpu import unoptimized_jax_compiles  # noqa: F401  (one thread)

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.linalg as JL
import paddle_tpu.tensor as J
import paddle_tpu_torch as tp
import paddle_tpu_torch.linalg as TL
import paddle_tpu_torch.tensor as T
from torch_op_parity import (EW, RED, Case, JaxRefs, arr, check, close,
                             run_case, to_np)

B = (2, 5, 5)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    yield


def _spd(r, shape=B):
    m = arr(r, shape)
    return (m @ np.swapaxes(m, -1, -2) + shape[-1] * np.eye(shape[-1])) \
        .astype(np.float32)


def _cases():
    n = "normal"
    c = {}

    def add(cid, name, make, kw=None, diff=(0,), tol=RED):
        # the JAX dist branches on p in Python: it runs eagerly
        c[cid] = Case(name, getattr(J, name), getattr(T, name),
                      make(np.random.RandomState(41)), kw, diff, tol,
                      eager=name in ("dist", "lstsq", "cond"))

    add("norm-fro", "norm", lambda r: [arr(r, B, n)])
    add("norm-2-axis", "norm", lambda r: [arr(r, B, n)], {"axis": 1})
    add("norm-1", "norm", lambda r: [arr(r, B, n)], {"p": 1, "axis": -1})
    add("norm-inf", "norm", lambda r: [arr(r, B, n)],
        {"p": float("inf"), "axis": 2, "keepdim": True})
    add("norm--inf", "norm", lambda r: [arr(r, B, n)],
        {"p": float("-inf"), "axis": 0})
    add("norm-0", "norm", lambda r: [arr(r, B, n)], {"p": 0, "axis": 1},
        ())
    add("norm-3", "norm", lambda r: [arr(r, B, n)], {"p": 3.0})
    add("norm-fro-axes", "norm", lambda r: [arr(r, B, n)],
        {"p": "fro", "axis": [1, 2]})
    add("norm-nuc", "norm", lambda r: [arr(r, (5, 4), n)], {"p": "nuc"})
    add("p_norm", "p_norm", lambda r: [arr(r, B, n)], {"p": 2, "axis": 2})
    add("vector_norm", "vector_norm", lambda r: [arr(r, B, n)],
        {"p": 1.5, "axis": 1})
    add("matrix_norm", "matrix_norm", lambda r: [arr(r, B, n)])
    add("cond", "cond", lambda r: [arr(r, (5, 5), n)], {}, (), 1e-3)
    add("cholesky", "cholesky", lambda r: [_spd(r)])
    add("cholesky-upper", "cholesky", lambda r: [_spd(r)], {"upper": True})
    add("cholesky_solve", "cholesky_solve", lambda r: [
        arr(r, (2, 5, 3), n), np.linalg.cholesky(_spd(r))], {}, (0, 1))
    add("inv", "inv", lambda r: [_spd(r)])
    add("inverse", "inverse", lambda r: [arr(r, B, n)])
    add("det", "det", lambda r: [arr(r, B, n)])
    add("slogdet", "slogdet", lambda r: [arr(r, B, n)])
    add("svdvals", "svdvals", lambda r: [arr(r, (2, 5, 3), n)])
    add("eigvalsh", "eigvalsh", lambda r: [arr(r, B, n)])
    add("matrix_power", "matrix_power", lambda r: [arr(r, B, n) / 2],
        {"n": 3})
    add("matrix_power-neg", "matrix_power", lambda r: [_spd(r)], {"n": -2})
    add("matrix_rank", "matrix_rank", lambda r: [_low_rank(r)], {}, ())
    add("matrix_rank-tol", "matrix_rank", lambda r: [_low_rank(r)],
        {"tol": 0.5}, ())
    add("pinv", "pinv", lambda r: [arr(r, (2, 5, 3), n)], {"rcond": 1e-6})
    add("solve", "solve", lambda r: [_spd(r), arr(r, (2, 5, 2), n)], {},
        (0, 1))
    add("triangular_solve", "triangular_solve", lambda r: [
        _tri(r), arr(r, (2, 5, 2), n)], {}, (0, 1))
    add("triangular_solve-lower-t-unit", "triangular_solve", lambda r: [
        _tri(r), arr(r, (2, 5, 2), n)],
        {"upper": False, "transpose": True, "unitriangular": True}, (0, 1))
    add("lstsq", "lstsq", lambda r: [arr(r, (7, 4), n), arr(r, (7, 2), n)],
        {}, ())
    add("lstsq-rank-deficient", "lstsq", lambda r: [
        _low_rank(r)[0, :, :4], arr(r, (5, 2), n)], {"rcond": 1e-3}, ())
    add("cross", "cross", lambda r: [arr(r, (4, 3), n), arr(r, (4, 3), n)],
        {}, (0, 1), EW)
    add("cross-axis", "cross", lambda r: [arr(r, (3, 3, 2), n),
                                          arr(r, (3, 3, 2), n)],
        {"axis": 1}, (0, 1), EW)
    add("corrcoef", "corrcoef", lambda r: [arr(r, (3, 8), n)])
    add("corrcoef-cols", "corrcoef", lambda r: [arr(r, (8, 3), n)],
        {"rowvar": False})
    add("cov", "cov", lambda r: [arr(r, (3, 8), n)])
    add("cov-biased-cols", "cov", lambda r: [arr(r, (8, 3), n)],
        {"rowvar": False, "ddof": False})
    add("householder_product", "householder_product", lambda r: [
        arr(r, (2, 5, 3), n), arr(r, (2, 3), "prob")], {}, (0, 1))
    add("dist", "dist", lambda r: [arr(r, (4, 5), n), arr(r, (5,), n)], {},
        (0, 1))
    add("dist-0", "dist", lambda r: [arr(r, (4, 5), n), arr(r, (4, 5), n)],
        {"p": 0}, ())
    add("dist-inf", "dist", lambda r: [arr(r, (4, 5), n), arr(r, (4, 5), n)],
        {"p": float("inf")}, (0, 1))
    add("dist-3", "dist", lambda r: [arr(r, (4, 5), n), arr(r, (4, 5), n)],
        {"p": 3}, (0, 1))
    return c


def _low_rank(r):
    return (arr(r, (2, 5, 2)) @ arr(r, (2, 2, 5))).astype(np.float32)


def _tri(r):
    a = np.triu(arr(r, B)) + 3 * np.eye(5, dtype=np.float32)
    return a.astype(np.float32)


CASES = _cases()


@pytest.fixture(scope="module")
def refs():
    return JaxRefs(CASES)


@pytest.mark.parametrize("cid", list(CASES))
def test_linalg_op(cid, refs):
    run_case(cid, CASES[cid], refs)


def test_linalg_namespace_is_the_library():
    assert TL.norm is T.norm and TL.lu is T.lu and TL.histogram is \
        T.histogram
    x = arr(np.random.RandomState(42), B)
    check("matmul", JL.matmul, TL.matmul, [x, x], {}, (0, 1), RED)


def test_lu_pivots_are_one_based_int32():
    a = arr(np.random.RandomState(43), B)
    check("lu", J.lu, T.lu, [a], {}, (), RED)
    check("lu", J.lu, T.lu, [a], {"get_infos": True}, (), RED)
    lu_, piv = T.lu(torch.tensor(a))
    assert piv.dtype == torch.int32 and int(piv.min()) >= 1


def _recon_svd(u, s, vh):
    return (u * s[..., None, :]) @ vh


def test_svd_through_its_reconstruction():
    a = arr(np.random.RandomState(44), (2, 6, 4))
    for full in (False, True):
        u, s, vh = T.svd(torch.tensor(a), full_matrices=full)
        ju, js, jvh = J.svd(jpaddle.to_tensor(a), full_matrices=full)
        close(to_np(s), to_np(js), RED, "svd singular values")
        k = s.shape[-1]
        close(to_np(_recon_svd(u[..., :k], s, vh[..., :k, :])), a, RED,
              "svd reconstruction")
        assert tuple(u.shape) == tuple(ju.shape) and \
            tuple(vh.shape) == tuple(jvh.shape)
    check("svdvals", J.svdvals, T.svdvals, [a], {}, (0,), RED)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_through_its_reconstruction(mode):
    a = arr(np.random.RandomState(45), (2, 6, 4))
    q, r = T.qr(torch.tensor(a), mode=mode)
    jq, jr = J.qr(jpaddle.to_tensor(a), mode=mode)
    assert tuple(q.shape) == tuple(jq.shape) and \
        tuple(r.shape) == tuple(jr.shape)
    close(to_np(q @ r), a, RED, "qr reconstruction")
    close(to_np(torch.triu(r)), to_np(r), 0.0, "R upper triangular")
    eye = torch.eye(q.shape[-1])
    close(to_np(q.transpose(-1, -2) @ q), to_np(eye.expand_as(
        q.transpose(-1, -2) @ q)), RED, "Q orthonormal")
    # |R|'s diagonal is sign-free
    close(to_np(r.diagonal(0, -2, -1).abs()),
          np.abs(np.diagonal(to_np(jr), 0, -2, -1)), RED, "|diag R|")


def test_eig_and_eigvals_through_sorted_eigenvalues():
    a = arr(np.random.RandomState(46), B)
    w, v = T.eig(torch.tensor(a))
    jw, _ = J.eig(jpaddle.to_tensor(a))
    key = lambda z: np.sort_complex(np.round(z, 4))  # noqa: E731
    close(np.stack([key(x) for x in to_np(w)]),
          np.stack([key(x) for x in to_np(jw)]), RED, "eig values")
    at = torch.tensor(a).to(torch.complex64)
    close(to_np(at @ v), to_np(v * w[..., None, :]), RED, "A V = V diag(w)")
    wv = T.eigvals(torch.tensor(a))
    close(np.stack([key(x) for x in to_np(wv)]),
          np.stack([key(x) for x in to_np(J.eigvals(jpaddle.to_tensor(a)))]),
          RED, "eigvals")


def test_eigh_through_eigenvalues_and_reconstruction():
    a = arr(np.random.RandomState(47), B)
    check("eigh", J.eigh, T.eigh, [a], {}, (0,), RED, outs=[0])
    w, v = T.eigh(torch.tensor(a))
    sym = (a + np.swapaxes(a, -1, -2)) / 2
    close(to_np((v * w[..., None, :]) @ v.transpose(-1, -2)), sym, RED,
          "eigh reconstruction")


# --------------------------------------------------------------------------
# random
# --------------------------------------------------------------------------

N = 20000
RANDOM = [
    ("uniform", lambda m: m.uniform([N], min=-2.0, max=3.0)),
    ("rand", lambda m: m.rand([N])),
    ("randn", lambda m: m.randn([N])),
    ("standard_normal", lambda m: m.standard_normal([N])),
    ("normal", lambda m: m.normal(1.5, 2.0, [N])),
    ("gaussian", lambda m: m.gaussian([N], mean=-1.0, std=0.5)),
    ("randint", lambda m: m.randint(-3, 7, [N])),
    ("randperm", lambda m: m.randperm(N)),
]


def _jt(m, a):
    return jpaddle.to_tensor(a) if m is J else torch.tensor(a)


RANDOM_ON = [
    ("uniform_", lambda m: m.uniform_(_jt(m, np.zeros(N, np.float32)),
                                      min=0.0, max=2.0)),
    ("normal_", lambda m: m.normal_(_jt(m, np.zeros(N, np.float32)),
                                    mean=3.0, std=0.25)),
    ("bernoulli", lambda m: m.bernoulli(_jt(m, np.full(N, 0.3,
                                                       np.float32)))),
    ("bernoulli_", lambda m: m.bernoulli_(_jt(m, np.zeros(N, np.float32)),
                                          p=0.7)),
    ("exponential_", lambda m: m.exponential_(
        _jt(m, np.zeros(N, np.float32)), lam=2.0)),
    ("poisson", lambda m: m.poisson(_jt(m, np.full(N, 4.0, np.float32)))),
    ("binomial", lambda m: m.binomial(_jt(m, np.full(N, 10.0, np.float32)),
                                      _jt(m, np.full(N, 0.3, np.float32)))),
    ("randint_like", lambda m: m.randint_like(
        _jt(m, np.zeros(N, np.float32)), 2, 5)),
    ("shuffle", lambda m: m.shuffle(_jt(m, np.arange(N, dtype=np.float32)))),
    ("multinomial", lambda m: m.multinomial(
        _jt(m, np.array([0.1, 0.2, 0.7], np.float32)), 2000, True)),
    ("multinomial-rows", lambda m: m.multinomial(
        _jt(m, np.array([[1.0, 3.0], [2.0, 2.0]], np.float32)), 1000,
        True)),
]


@pytest.fixture(scope="module")
def jax_draws():
    """Every JAX draw of the table from one ``jax.jit`` (one compile)."""
    import jax
    jpaddle.seed(5)

    def run():
        return [draw(J).data for _, draw in RANDOM + RANDOM_ON]
    return dict(zip([n for n, _ in RANDOM + RANDOM_ON],
                    (to_np(a) for a in jax.jit(run)())))


@pytest.mark.parametrize("name,draw", RANDOM + RANDOM_ON,
                         ids=[n for n, _ in RANDOM + RANDOM_ON])
def test_random_draws_match_jax_in_law(name, draw, jax_draws):
    """Shape, dtype kind, range and the first two moments against a JAX
    draw (the mean within 8 standard errors, the standard deviation
    within 5%); equal draws again under ``seed``."""
    want = jax_draws[name]
    tp.seed(5)
    got = to_np(draw(T))
    assert got.shape == want.shape, name
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    assert got.min() >= want.min() - 4 * want.std() - 1e-6 and \
        got.max() <= want.max() + 4 * want.std() + 1e-6
    se = max(float(want.std()), 1e-3) / np.sqrt(got.size)
    assert abs(float(got.mean()) - float(want.mean())) < 8 * se, name
    assert abs(float(got.std()) - float(want.std())) < \
        0.05 * max(float(want.std()), 1e-3), name
    tp.seed(5)
    again = to_np(draw(T))
    np.testing.assert_array_equal(got, again)


def test_random_explicit_generator_and_seed_argument():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(T.randn([5], generator=g1, device="cpu"),
                       T.randn([5], generator=g2, device="cpu"))
    a = T.uniform([6], seed=11, device="cpu")
    tp.seed(0)
    b = T.uniform([6], seed=11, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, T.uniform([6]))
    x = torch.arange(6.0).reshape(3, 2)
    s = T.shuffle(x, generator=torch.Generator().manual_seed(1))
    assert sorted(s[:, 0].tolist()) == [0.0, 2.0, 4.0]
    assert torch.equal(s[:, 1] - s[:, 0], torch.ones(3))
    assert T.randint(5, shape=[100]).max() < 5
    assert T.randperm(10, dtype="int32").dtype == torch.int32
    assert T.next_key("cpu") is tp.core.random.get_generator("cpu")


def test_normal_with_tensor_moments():
    m = torch.tensor([0.0, 10.0])
    s = torch.tensor([[1.0], [0.1]])
    out = T.normal(m, s)
    jout = J.normal(jpaddle.to_tensor(m.numpy()), jpaddle.to_tensor(
        s.numpy()))
    assert tuple(out.shape) == tuple(jout.shape) == (2, 2)


# --------------------------------------------------------------------------
# sequence
# --------------------------------------------------------------------------

LENS = np.array([3, 1, 5, 0], np.int64)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "first",
                                  "last"])
def test_sequence_pool(pool):
    x = arr(np.random.RandomState(51), (4, 5, 3))
    check("sequence_pool", J.sequence_pool, T.sequence_pool,
          [x, LENS], {"pool_type": pool}, (0,), RED)


@pytest.mark.parametrize("name", ["sequence_softmax", "sequence_reverse",
                                  "sequence_first_step",
                                  "sequence_last_step"])
def test_sequence_masked_ops(name):
    x = arr(np.random.RandomState(52), (4, 5))
    check(name, getattr(J, name), getattr(T, name), [x, LENS], {}, (0,),
          EW)


def test_sequence_enumerate_and_expand():
    x = arr(np.random.RandomState(53), (3, 5))
    check("sequence_enumerate", J.sequence_enumerate, T.sequence_enumerate,
          [x], {"win_size": 3, "pad_value": -1.0}, (0,))
    check("sequence_expand", J.sequence_expand, T.sequence_expand,
          [x, np.array([2, 0, 3], np.int64)], {}, ())


def test_sequence_pad_unpad_concat_slice():
    rng = np.random.RandomState(54)
    rows = [arr(rng, (k, 2)) for k in (3, 1, 4)]
    jp_, jl = J.sequence_pad(rows, pad_value=-1.0, maxlen=5)
    tp_, tl = T.sequence_pad(rows, pad_value=-1.0, maxlen=5)
    close(to_np(tp_), to_np(jp_), 0.0)
    close(to_np(tl), to_np(jl), 0.0)
    for a, b in zip(T.sequence_unpad(tp_, tl), J.sequence_unpad(jp_, jl)):
        close(to_np(a), to_np(b), 0.0)
    x1, x2 = arr(rng, (3, 4, 2)), arr(rng, (3, 2, 2))
    l1, l2 = np.array([4, 0, 2], np.int64), np.array([1, 2, 2], np.int64)
    check("sequence_concat",
          lambda a, b, c, d: J.sequence_concat([a, b], [c, d]),
          lambda a, b, c, d: T.sequence_concat([a, b], [c, d]),
          [x1, x2, l1, l2], {}, ())
    check("sequence_slice", J.sequence_slice, T.sequence_slice,
          [x1, l1, np.array([1, 0, 0], np.int64),
           np.array([2, 0, 1], np.int64)], {}, ())
    with pytest.raises(ValueError, match="exceeds"):
        T.sequence_slice(torch.tensor(x1), torch.tensor(l1),
                         torch.tensor([3, 0, 0]), torch.tensor([2, 0, 1]))
