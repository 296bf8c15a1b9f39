"""MoE routed over the data axis on the CPU: a batch split into p data
groups' shards, each routed with its ``moe.Share`` (filled by
``share_out`` from every shard's claims), against ``route`` on the whole
batch: the same queue position for every claim, the same global choice-0
fractions and capacity; and ``moe_forward`` on the shares against the
whole: each shard's rows of the output, and the mean of the shards' aux
losses, which is the whole's, in value and in gradient. Shapes where a
routing group spans data groups (4 x 32 at p 2 and 4, 4 x 384 at p 4)
and where each lies in one (4 x 256 at p 2), with the capacity cut so
that claims drop."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import tree_leaves, tree_unflatten

# fp32; the shards' products and sums run at other shapes
RTOL = 1e-5
CASES = [(4, 32, 2), (4, 32, 4), (4, 256, 2), (4, 384, 4)]


def _setup(B, L, cf=0.5, n_shared=0):
    cfg = get_config("mixtral-8x7b", smoke=True)
    cfg = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf,
                                n_shared=n_shared))
    rng = np.random.default_rng(0)
    p = tree_unflatten(
        (path, torch.from_numpy((rng.standard_normal(s.shape) / np.sqrt(
            s.shape[-2])).astype(np.float32)))
        for path, s in tree_leaves(moe.moe_specs(cfg)))
    x = torch.from_numpy(rng.standard_normal(
        (B, L, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def _shares(cfg, p, x, n_groups):
    """Each shard of ``x`` (by batch rows) and its filled ``Share``."""
    xs = list(x.chunk(n_groups))
    n = xs[0].shape[0] * xs[0].shape[1]
    shares = [moe.Share(n * n_groups, d * n) for d in range(n_groups)]
    claims = [moe.route(cfg, p, xd, sh)["claims"]
              for xd, sh in zip(xs, shares)]
    moe.share_out(shares, claims, "cpu")
    return xs, shares


@pytest.mark.parametrize("B,L,n_groups", CASES,
                         ids=lambda v: str(v))
def test_shares_route_as_the_whole_batch(B, L, n_groups):
    cfg, p, x = _setup(B, L)
    whole = moe.route(cfg, p, x)
    K = cfg.moe.top_k
    w_pos = whole["pos"].reshape(-1, K)
    w_exp = whole["expert"].reshape(-1, K)
    kept = (w_pos < whole["C"]).float().mean()
    assert 0.0 < kept < 1.0, "the capacity must drop some claims"
    w_frac = whole["onehot"][:, :, 0].float().mean(dim=(0, 1))
    xs, shares = _shares(cfg, p, x, n_groups)
    n = xs[0].shape[0] * xs[0].shape[1]
    for d, (xd, sh) in enumerate(zip(xs, shares)):
        r = moe.route(cfg, p, xd, sh)
        lead, m = r["span"]
        assert m == n and r["C"] == whole["C"]
        rows = slice(d * n, (d + 1) * n)
        got_pos = r["pos"].reshape(-1, K)[lead:lead + n]
        got_exp = r["expert"].reshape(-1, K)[lead:lead + n]
        assert torch.equal(got_exp, w_exp[rows]), d
        assert torch.equal(got_pos, w_pos[rows]), d
        assert torch.equal(r["frac"], w_frac), d
        # the padding claims nothing, so the claims are the shard's own
        assert int(r["claims"].sum()) == n * K
    assert not torch.stack([f for sh in shares
                            for f in sh.mismatches]).any()


@pytest.mark.parametrize("B,L,n_groups", CASES,
                         ids=lambda v: str(v))
def test_moe_forward_on_shares_is_the_whole_batchs(B, L, n_groups):
    cfg, p, x = _setup(B, L, n_shared=1)
    leaves = dict(tree_leaves(p))
    for t in leaves.values():
        t.requires_grad_(True)
    probe = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(x.shape)).astype(np.float32))
    out, aux = moe.moe_forward(cfg, p, x)
    g_whole = torch.autograd.grad((out * probe).mean() + aux,
                                  list(leaves.values()))
    xs, shares = _shares(cfg, p, x, n_groups)
    outs, auxes = zip(*(moe.moe_forward(cfg, p, xd, sh)
                        for xd, sh in zip(xs, shares)))
    got = torch.cat(outs).detach()
    scale = float(out.detach().abs().max())
    np.testing.assert_allclose(got.numpy(), out.detach().numpy(), rtol=RTOL,
                               atol=RTOL * scale)
    mean_aux = torch.stack(auxes).mean()
    np.testing.assert_allclose(float(mean_aux), float(aux), rtol=RTOL)
    g_parts = torch.autograd.grad(
        (torch.cat(outs) * probe).mean() + mean_aux, list(leaves.values()))
    for k, gw, gp in zip(leaves, g_whole, g_parts):
        np.testing.assert_allclose(gp.numpy(), gw.numpy(), rtol=RTOL,
                                   atol=RTOL * float(gw.abs().max()) + 1e-12,
                                   err_msg=k)


def test_a_share_checks_the_global_token_count():
    """The reference's reshape fails where the global tokens do not split
    into groups; a shard that does not fill its groups is fine."""
    cfg, p, x = _setup(4, 32)
    with pytest.raises(ValueError):
        moe.route(cfg, p, x[:2], moe.Share(64 * 12, 0))  # 768 % 512
    moe.route(cfg, p, x[:1], moe.Share(32 * 4, 32))
