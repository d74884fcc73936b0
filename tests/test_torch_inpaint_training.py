"""The port's E2FGVI GAN trainer (`vosesam_tpu_torch/training/inpaint_trainer.py`)
against `vosesam_tpu.training.inpaint_trainer` on the CPU, fp32, at the JAX
package's own test size (`tests/test_inpaint_training.py`: T 3, 48 x 48, 2
local frames, one focal block).

Weights: the port's seeded generator (offset heads with small random
weights, so the deformable alignment sees per-(group, tap) offsets) carried
to JAX by the JAX package's `state_dict_to_tree`; a discriminator drawn
with numpy whose u and v are spectral norm's converged vectors (a fresh
random u / v makes sigma a small fraction of the largest singular value,
and the hinge logits reach 1e8: the generator's gradient is then the
adversarial term's alone, rounding included).

Tolerances, set before any reading:
  - losses: 1e-4 relative (fp32 convolutions summed in another order);
  - gradients per leaf: ||g_port - g_jax|| <= 1e-4 ||g_jax|| on >= 90% of
    the leaves of each network, and <= 5e-3 ||g_jax|| on every leaf. A
    first bound of 1e-3 on every leaf failed on the encoder's last layers
    (1.35e-3); in float64 the port's gradient of the worst leaf
    (encoder.layers.8) lies 8.3e-4 from the exact one and JAX's fp32
    gradient 2.0e-3: fp32 rounding through ~40 layers, their backward and
    SPyNet's warps reaches 1e-3 of these leaves in either framework, while
    the median leaf agrees to 5e-6;
  - the Adam update against optax's on the same gradients: 1e-6 of lr plus
    one rounding of the parameter (XLA may fuse p + (-lr) u into one
    multiply-add; a first bound of 1e-6 of lr alone was below fp32's
    resolution at |p| ~ 0.1 and failed by one ulp);
  - the parameters after one `train_step` against JAX's: with b1 = 0 the
    first step moves an element by lr * g / (|g| + eps), about +-lr, so a
    gradient of rounding size may flip its sign. Where |g_jax| > 100
    |g_jax - g_port| (the sign is certain there) or both are exactly 0
    (>= 90% of the elements)
    within lr / 400 plus the Adam update's tolerance: u(g) = g / (|g| + eps)
    moves by at most eps |dg| / (|g| + eps)^2 <= 1 / 400 of a step for such
    a dg (a first bound without that term failed where |g| ~ eps = 1e-8, by
    up to 9e-8); within 2 lr + 1e-6 of lr everywhere;
  - u and v after the step: 1e-5 absolute (unit vectors, one power
    iteration on each of the real and fake passes).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from vosesam_tpu.config import InpainterConfig as JInpainterConfig
from vosesam_tpu.models.e2fgvi import discriminator as JD
from vosesam_tpu.models.e2fgvi import generator as JG
from vosesam_tpu.models.e2fgvi.losses import flow_completion_loss as j_flow_loss
from vosesam_tpu.training import inpaint_trainer as JIT
from vosesam_tpu.utils.checkpoint import state_dict_to_tree
from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.models.e2fgvi import discriminator as TD
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.training import inpaint_trainer as TIT
from vosesam_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_e2fgvi import published_roundings

JCFG = JInpainterConfig(num_blocks=1)
TCFG = InpainterConfig(num_blocks=1)
T, H, W, NL = 3, 48, 48, 2
LOSS_REL = 1e-4
GRAD_REL = 5e-3           # every leaf
GRAD_REL_MOST = 1e-4      # >= 90% of the leaves
LR = TIT.InpaintTrainConfig().lr
ULP = 2.0 ** -23          # one rounding of an fp32 parameter, relative


@pytest.fixture(autouse=True, scope="module")
def _published_roundings():
    """The JAX package's E2FGVI at the roundings the port follows
    (`tests.test_torch_e2fgvi.published_roundings`)."""
    with published_roundings():
        yield


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _gen_tree():
    net = TG.generator_init(TCFG, seed=0, device="cpu")
    r = np.random.default_rng(11)
    with torch.no_grad():
        for align in net.feat_prop_module.deform_align.values():
            last = align.conv_offset[6]
            last.weight.copy_(torch.from_numpy(
                (0.02 * r.standard_normal(last.weight.shape)).astype(np.float32)))
            last.bias.copy_(torch.from_numpy(
                (0.1 * r.standard_normal(last.bias.shape)).astype(np.float32)))
    return state_dict_to_tree(net.state_dict())


def _disc_tree():
    """He-normal weights, zero bias, converged spectral-norm vectors."""
    r = np.random.default_rng(12)
    chans = [(3, 32), (32, 64), (64, 128), (128, 128), (128, 128), (128, 128)]
    tree = {"conv": {}}
    for i, (cin, cout) in enumerate(chans):
        w = r.standard_normal((3, 5, 5, cin, cout)) * np.sqrt(2.0 / (75 * cin))
        p = {"weight": w.astype(np.float32)}
        if i < 5:
            wm = np.transpose(w, (4, 3, 0, 1, 2)).reshape(cout, -1)
            u = r.standard_normal(cout)
            for _ in range(200):
                v = wm.T @ u
                v /= np.linalg.norm(v)
                u = wm @ v
                u /= np.linalg.norm(u)
            p["u"], p["v"] = u.astype(np.float32), v.astype(np.float32)
        else:
            p["bias"] = np.zeros(cout, np.float32)
        tree["conv"][str(2 * i)] = p
    return tree


def _batch():
    r = np.random.default_rng(0)
    frames = r.uniform(-1, 1, (T, H, W, 3)).astype(np.float32)
    masks = np.zeros((T, H, W, 1), np.float32)
    masks[:, 12:30, 10:36] = 1.0
    return frames, masks


def _port_state(trees):
    gen = TG.InpaintGenerator(TCFG)
    gen.load_state_dict(params_from_jax(trees["gen"]), strict=True)
    disc = TD.Discriminator()
    disc.load_state_dict(params_from_jax(trees["disc"]), strict=True)
    return TIT.init_train_state(gen, disc)


@pytest.fixture(scope="module")
def trees():
    return {"gen": _gen_tree(), "disc": _disc_tree()}


@pytest.fixture(scope="module")
def jax_step(trees):
    """JAX's gradients (its train_step's loss functions, written out with
    its public functions) and JAX's own `train_step`, on the same batch."""
    frames, masks = map(jnp.asarray, _batch())
    tcfg = JIT.InpaintTrainConfig()
    state = JIT.init_train_state(jax.tree.map(jnp.asarray, trees["gen"]),
                                 jax.tree.map(jnp.asarray, trees["disc"]), tcfg)

    def gen_loss(gp, disc, frozen, fr, mk):
        pred, flows = JG.generator_forward(gp, fr * (1.0 - mk), NL, JCFG, remat=True)
        comp = fr * (1.0 - mk) + pred * mk
        adv = -jnp.mean(JD.discriminator_forward(disc, comp[None])[0])
        total = (JIT._masked_l1(pred, fr, mk) + JIT._masked_l1(pred, fr, 1.0 - mk)
                 + j_flow_loss(frozen, flows, (fr[:NL] + 1.0) / 2.0) + 0.01 * adv)
        return total, jax.lax.stop_gradient(comp)

    def disc_loss(dp, fr, comp):
        d_real, nd = JD.discriminator_forward(dp, fr[None], update_sn=True)
        d_fake, nd = JD.discriminator_forward(nd, comp[None], update_sn=True)
        return (jnp.mean(jax.nn.relu(1.0 - d_real)) + jnp.mean(jax.nn.relu(1.0 + d_fake))) / 2.0

    (_, comp), gen_grads = jax.jit(jax.value_and_grad(gen_loss, has_aux=True))(
        state.gen, state.disc, state.spynet_frozen, frames, masks)
    disc_grads = jax.jit(jax.grad(disc_loss))(state.disc, frames, comp)
    new_state, metrics = jax.jit(lambda s, f, m: JIT.train_step(s, f, m, NL, JCFG, tcfg))(
        state, frames, masks)
    tree = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return dict(gen_grads=params_from_jax(tree(gen_grads)),
                disc_grads=params_from_jax(tree(disc_grads)), state=state,
                new_gen=params_from_jax(tree(new_state.gen)),
                new_disc=params_from_jax(tree(new_state.disc)),
                metrics={k: float(v) for k, v in metrics.items()}, it=int(new_state.it))


@pytest.fixture(scope="module")
def port_step(trees):
    """The port's gradients and its `train_step` from the same weights."""
    frames, masks = map(torch.from_numpy, _batch())
    tcfg = TIT.InpaintTrainConfig()
    state = _port_state(trees)
    gen_grads, disc_grads, _ = TIT.step_gradients(state, frames, masks, NL, TCFG, tcfg)
    stepped = _port_state(trees)
    stepped, metrics = TIT.train_step(stepped, frames, masks, NL, TCFG, tcfg)
    return dict(gen_grads=gen_grads, disc_grads=disc_grads, state=stepped,
                metrics={k: float(v) for k, v in metrics.items()})


def test_losses_match_jax(jax_step, port_step):
    want, got = jax_step["metrics"], port_step["metrics"]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL, abs=1e-6), k
    # a converged discriminator: the hinge terms are O(1), not saturated
    assert abs(want["gen_adv"]) < 100


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_gradients_per_leaf_match_jax(jax_step, port_step, net):
    want, got = jax_step[f"{net}_grads"], port_step[f"{net}_grads"]
    # JAX's u / v leaves get zero gradients; in the port they are buffers
    for k in set(want) - set(got):
        assert k.endswith(("weight_u", "weight_v")) and not want.pop(k).any(), k
    assert set(got) == set(want)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values())))
    rel = {}
    for k, w in want.items():
        rel[k] = float((got[k] - w).norm()) / max(float(w.norm()), 1e-6 * total)
        assert rel[k] <= GRAD_REL, f"{k}: {rel[k]} of |g|"
    assert np.mean([r <= GRAD_REL_MOST for r in rel.values()]) >= 0.9, sorted(rel.values())


def test_adam_update_matches_optax_on_the_same_gradients(trees, jax_step):
    """`apply_adam` on JAX's gradients against optax.adam(1e-4, 0, 0.99):
    two steps, so the second moment's bias correction is exercised."""
    tcfg = TIT.InpaintTrainConfig()
    opt = optax.adam(tcfg.lr, b1=tcfg.beta1, b2=tcfg.beta2)
    jparams = jax.tree.map(jnp.asarray, trees["disc"])
    jgrads = jax.tree.map(jnp.asarray, trees["disc"])        # any tree of the right shapes
    jgrads = jax.tree.map(lambda g: 0.5 * g + 0.1, jgrads)
    ostate = opt.init(jparams)
    state = _port_state(trees)
    grads = {k: v for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()
             if k in dict(state.disc.named_parameters())}
    for _ in range(2):
        upd, ostate = opt.update(jgrads, ostate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        TIT.apply_adam(state.disc, state.disc_opt, grads, tcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert state.disc_opt.count == 2
    for k, p in state.disc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=ULP,
                                   atol=1e-6 * tcfg.lr, err_msg=k)


def test_train_step_matches_jax_train_step(jax_step, port_step):
    state = port_step["state"]
    assert state.it == jax_step["it"] == 1
    assert state.gen_opt.count == state.disc_opt.count == 1
    for net, module in (("gen", state.gen), ("disc", state.disc)):
        want, g_jax, g_port = (jax_step[f"new_{net}"], jax_step[f"{net}_grads"],
                               port_step[f"{net}_grads"])
        certain = []
        for k, p in module.named_parameters():
            d = (p.detach() - want[k]).abs()
            # the sign is certain, or both gradients are exactly 0 (the last
            # layer's bias, and its taps that only ever see padding)
            sure = ((g_jax[k].abs() > 100 * (g_jax[k] - g_port[k]).abs())
                    | ((g_jax[k] == 0) & (g_port[k] == 0)))
            assert bool((d <= LR / 400 + 1e-6 * LR + ULP * want[k].abs())[sure].all()), k
            assert float(d.max()) <= 2 * LR + 1e-6 * LR, k
            certain.append(sure.flatten())
        assert float(torch.cat(certain).float().mean()) >= 0.9, net
    # the spectral-norm vectors: iterated on the real and fake passes, kept
    # as buffers (unit norm), and not trained
    for k, b in state.disc.named_buffers():
        np.testing.assert_allclose(b.numpy(), jax_step["new_disc"][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        assert float(b.norm()) == pytest.approx(1.0, abs=1e-5)
    assert not any(b.requires_grad for b in state.disc.buffers())


def test_remat_on_equals_off(trees):
    """Remat recomputes the same stages: equal outputs under no_grad, and
    equal gradients."""
    frames, masks = map(torch.from_numpy, _batch())
    state = _port_state(trees)
    with torch.no_grad():
        on = TG.generator_forward(state.gen, frames, NL, TCFG, remat=True)
        off = TG.generator_forward(state.gen, frames, NL, TCFG, remat=False)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1][0], off[1][0])
    grads = {}
    for remat in (True, False):
        st = _port_state(trees)
        tcfg = TIT.InpaintTrainConfig(remat=remat)
        grads[remat] = TIT.step_gradients(st, frames, masks, NL, TCFG, tcfg)[0]
    for k, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][k], rtol=0,
                                   atol=1e-6 * float(g.abs().max()) + 1e-30, msg=k)


def test_init_state_and_masked_l1():
    """The frozen SPyNet is a detached copy; _masked_l1 matches JAX's
    normalisation, an empty mask gives 0."""
    gen = TG.generator_init(TCFG, seed=1, device="cpu")
    state = TIT.init_train_state(gen, TD.discriminator_init(device="cpu"))
    frozen = dict(state.spynet_frozen.named_parameters())
    for k, p in gen.update_spynet.named_parameters():
        assert torch.equal(frozen[k], p) and frozen[k] is not p and not frozen[k].requires_grad
    assert set(state.gen_opt.mu) == set(dict(gen.named_parameters()))
    pred = torch.ones((2, 4, 4, 3))
    mask = torch.zeros((2, 4, 4, 1))
    mask[:, :2] = 1.0
    assert float(TIT._masked_l1(pred, torch.zeros_like(pred), mask)) == pytest.approx(1.0)
    assert float(TIT._masked_l1(pred, torch.zeros_like(pred), torch.zeros_like(mask))) == 0.0
    r = np.random.default_rng(2)
    a, b = r.standard_normal((2, 5, 6, 3)), r.standard_normal((2, 5, 6, 3))
    m = (r.uniform(size=(2, 5, 6, 1)) > 0.5).astype(np.float32)
    want = float(JIT._masked_l1(*(jnp.asarray(x, jnp.float32) for x in (a, b, m))))
    got = float(TIT._masked_l1(*(torch.tensor(x, dtype=torch.float32) for x in (a, b, m))))
    assert got == pytest.approx(want, rel=1e-6)
