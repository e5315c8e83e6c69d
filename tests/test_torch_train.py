"""The port's training path against the JAX package on the CPU: the
diffusion and vision losses and their gradients against
``jax.value_and_grad`` of the same loss on the same params, batch, noise
and timesteps (passed across through numpy); three steps of
``make_train_step`` against the reference's; the adaLN kernel's
closed-form backward against autograd of its plain version; remat; and
serving, which must build no autograd graph."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import RippleConfig as JRipple  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.diffusion.schedule import DDPMSchedule as JDDPM  # noqa: E402
from repro.diffusion.schedule import \
    RectifiedFlowSchedule as JRF  # noqa: E402
from repro.launch.workloads import model_fns  # noqa: E402
from repro.models import dit as j_dit  # noqa: E402
from repro.models import efficientnet as j_eff  # noqa: E402
from repro.models import mmdit as j_mmdit  # noqa: E402
from repro.models import unet as j_unet  # noqa: E402
from repro.models import vdit as j_vdit  # noqa: E402
from repro.models import vit as j_vit  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import batch_generator  # noqa: E402
from repro_torch.kernels import refuse_grad  # noqa: E402
from repro_torch.kernels.adaln.ops import adaln_modulate_grads  # noqa: E402
from repro_torch.kernels.adaln.ref import adaln_modulate_ref  # noqa: E402
from repro_torch.launch import workloads  # noqa: E402
from repro_torch.models.params import init_model, jax_tree  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

torch.set_num_threads(2)

ARCHS = {"dit": "dit-b2", "vdit": "vdit-paper", "unet": "unet-sd15",
         "mmdit": "flux-dev", "vit": "vit-l16", "effnet": "efficientnet-b7"}
J_OFF = JRipple()
BATCH = 2


def _np_tree(t):
    """A ``jax_tree`` of torch tensors as numpy copies (a JAX array made
    from one may alias its memory, and the port updates in place)."""
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return np.array(t.detach().numpy(), copy=True, order="C")


def _setup(fam, seed=0):
    """(port arch, JAX arch, port model with every leaf random and
    requiring grad, the same params as a JAX tree)."""
    arch, jarch = get_smoke_config(ARCHS[fam]), j_smoke(ARCHS[fam])
    model = init_model(arch.model, seed=seed, device="cpu", zero_init=False)
    for p in model.parameters():
        p.requires_grad_(True)
    params = jax.tree_util.tree_map(jnp.asarray, _np_tree(jax_tree(model)))
    return arch, jarch, model, params


def _batch(fam, arch, seed=1, res=None):
    """A numpy batch at the smoke config's own resolution (a vision
    model's at ``res``), with the diffusion noise and timesteps the loss
    takes."""
    m = arch.model
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if fam in ("vit", "effnet"):
        res = res or m.img_res
        return {"images": normal(BATCH, res, res, m.in_channels),
                "labels": rng.integers(0, m.num_classes, BATCH)}
    if fam == "dit":
        lr = m.latent_res()
        b = {"latents": normal(BATCH, lr, lr, m.in_channels),
             "labels": rng.integers(0, m.num_classes, BATCH)}
    elif fam == "vdit":
        g = m.grid()
        b = {"latents": normal(BATCH, g[0] * m.t_patch, g[1] * m.patch,
                               g[2] * m.patch, m.in_channels),
             "txt": normal(BATCH, m.txt_tokens, m.txt_dim, scale=0.05)}
    elif fam == "unet":
        b = {"latents": normal(BATCH, m.latent_res, m.latent_res,
                               m.in_channels),
             "ctx": normal(BATCH, m.ctx_tokens, m.ctx_dim, scale=0.05)}
    else:
        b = {"latents": normal(BATCH, m.latent_res, m.latent_res,
                               m.in_channels),
             "txt": normal(BATCH, m.txt_tokens, m.txt_dim, scale=0.05),
             "vec": normal(BATCH, 768, scale=0.05)}
    b["noise"] = normal(*b["latents"].shape)
    b["t"] = (rng.uniform(size=BATCH).astype(np.float32) if fam == "mmdit"
              else rng.integers(0, 1000, BATCH))
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def j_loss(fam, jarch, params, batch, dt):
    """The reference workloads' losses (``_diffusion_train``,
    ``_vision_train``) with the noise and t taken from the batch and the
    compute dtype explicit."""
    m = jarch.model
    if fam in ("vit", "effnet"):
        apply = j_vit.vit_apply if fam == "vit" else j_eff.effnet_apply
        logits = apply(params, batch["images"], m,
                       compute_dtype=dt).astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, batch["labels"][:, None], 1)[:, 0]
        return jnp.mean(logz - gold)
    x0, noise, t = batch["latents"], batch["noise"], batch["t"]
    if fam == "mmdit":
        rf = JRF()
        xt = rf.interpolate(x0, noise, t)
        target = rf.velocity_target(x0, noise)
        pred = j_mmdit.mmdit_apply(params, xt, t, batch["txt"], batch["vec"],
                                   m, ripple=J_OFF, compute_dtype=dt)
    else:
        xt = JDDPM().add_noise(x0, noise, t)
        target = noise
        tf = t.astype(jnp.float32)
        if fam == "dit":
            pred = j_dit.dit_apply(params, xt, tf, batch["labels"], m,
                                   ripple=J_OFF, compute_dtype=dt)
            pred = pred[..., :m.in_channels]
        elif fam == "vdit":
            pred = j_vdit.vdit_apply(params, xt, tf, batch["txt"], m,
                                     ripple=J_OFF, compute_dtype=dt)
        else:
            pred = j_unet.unet_apply(params, xt, tf, batch["ctx"], m,
                                     ripple=J_OFF, compute_dtype=dt)
    return jnp.mean(jnp.square(pred.astype(jnp.float32)
                               - target.astype(jnp.float32)))


def t_loss(fam, arch, model, batch, dt, remat=False):
    if fam in ("vit", "effnet"):
        return workloads.vision_loss(arch, model, batch, compute_dtype=dt,
                                     remat=remat)[0]
    return workloads.diffusion_loss(arch, model, batch, batch["noise"],
                                    batch["t"], compute_dtype=dt)[0]


def _grads(model):
    return _np_tree(jax_tree(model, lambda p: p.grad))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree_rel(got, want):
    g = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(want)]
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(g, w))
    den = sum(float(np.sum(b ** 2)) for b in w)
    return (num / den) ** 0.5


def check_loss_and_grads(fam, dtype, res=None):
    """Loss and gradients of one family against ``jax.value_and_grad``.
    f32 compute: loss within 1e-5, gradients within 1e-4 tree relative
    L2 and 1e-3 per leaf (summation order only).  bf16 compute, the
    reference's default: the two frameworks round bf16 at other places,
    so the tree within 5e-2 and the loss within 2e-2.  ``res`` sets a
    vision model's image side (default the smoke config's)."""
    arch, jarch, model, params = _setup(fam)
    nb = _batch(fam, arch, res=res)
    dt_t, dt_j = getattr(torch, dtype), getattr(jnp, dtype)
    loss = t_loss(fam, arch, model, _torch_batch(nb), dt_t)
    loss.backward()
    loss = loss.detach()
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss(fam, jarch, p, b, dt_j)))(
            params, jax.tree_util.tree_map(jnp.asarray, nb))
    grads = _grads(model)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(j_grads)
    if dtype == "float32":
        assert _rel(float(loss), float(j_val)) <= 1e-5
        assert _tree_rel(grads, j_grads) <= 1e-4
        # per leaf relative to the larger of the leaf's norm and 1e-4 of
        # the tree's: a leaf whose gradient vanishes in exact arithmetic
        # (a conv bias ahead of a GroupNorm) holds only rounding noise
        leaves = jax.tree_util.tree_leaves_with_path(j_grads)
        floor = 1e-4 * np.sqrt(sum(float(np.sum(np.square(w)))
                                   for _, w in leaves))
        for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(grads)):
            err = np.linalg.norm(np.asarray(g, np.float64) - w)
            assert err <= 1e-3 * max(np.linalg.norm(w), floor), \
                jax.tree_util.keystr(path)
    else:
        assert _rel(float(loss), float(j_val)) <= 2e-2
        assert _tree_rel(grads, j_grads) <= 5e-2
    # every leaf trains: randomised params leave no gradient at zero
    assert all(np.any(g != 0) for g in jax.tree_util.tree_leaves(grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fam", ["dit", "vdit", "mmdit"])
def test_loss_and_grads_match_jax(fam, dtype):
    check_loss_and_grads(fam, dtype)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_jax_tree_has_the_reference_paths_and_shapes(fam):
    arch, jarch, model, params = _setup(fam)
    ref = jax.eval_shape(lambda: init_params(model_fns(jarch),
                                             jax.random.PRNGKey(0)))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_remat_gives_bit_equal_grads(fam):
    arch, _, model, _ = _setup(fam)
    batch = _torch_batch(_batch(fam, arch))
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        if fam in ("vit", "effnet"):
            loss = t_loss(fam, arch, model, batch, torch.float32, remat)
        else:
            kw = dict(compute_dtype=torch.float32, remat=remat,
                      ripple=arch.ripple.__class__())
            x, t = batch["latents"], batch["t"].float()
            if fam == "dit":
                pred = model(x, t, batch["labels"], **kw)[..., :x.shape[-1]]
            elif fam == "vdit":
                pred = model(x, t, batch["txt"], **kw)
            elif fam == "unet":
                pred = model(x, t, batch["ctx"], **kw)
            else:
                pred = model(x, batch["t"], batch["txt"], batch["vec"], **kw)
            loss = torch.mean(torch.square(pred - batch["noise"]))
        loss.backward()
        out.append([p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_train_loss_fn_draws_from_the_generator():
    """The thin wrapper: noise and t from the micro-batch's generator;
    the loss is the pure loss at those draws."""
    arch, _, model, _ = _setup("dit")
    batch = _torch_batch(_batch("dit", arch))
    batch.pop("noise"), batch.pop("t")
    arch32 = dataclasses.replace(arch, train=dataclasses.replace(
        arch.train, compute_dtype="float32"))
    loss_fn = workloads.train_loss_fn(arch32)
    gen = batch_generator(0, 3, 1)
    loss, _ = loss_fn(model, batch, gen)
    noise, t = workloads.draw_diffusion_noise(
        arch, batch["latents"], batch_generator(0, 3, 1))
    want, _ = workloads.diffusion_loss(arch, model, batch, noise, t,
                                       compute_dtype=torch.float32)
    assert float(loss.detach()) == float(want.detach())
    assert 0 <= int(t.min()) and int(t.max()) < 1000


def _coef(shape):
    """A float32 coefficient tensor of ``shape``: small multiples of 1/64
    from -125/64 to 125/64, the same in both packages."""
    n = int(np.prod(shape))
    c = ((np.arange(n, dtype=np.int64) * 7919 + n) % 251 - 125) / 64.0
    return c.astype(np.float32).reshape(shape)


@pytest.mark.parametrize("accum,ema,comp", [(1, 0.0, False), (2, 0.0, False),
                                            (2, 0.9, False), (2, 0.0, True)],
                         ids=["accum1", "accum2", "accum2+ema",
                              "accum2+compression"])
def test_make_train_step_matches_the_reference(accum, ema, comp):
    """Three steps of the dit with the noise carried in the batch dict:
    params, AdamW moments, EMA, the int8 compression residuals and
    metrics against the reference's ``make_train_step`` (float32
    compute).  The bars are f32 summation order, amplified by Adam's
    normalised first steps where a gradient is near zero.

    The compressed case trains on a loss linear in the parameters,
    ``sum(leaf * s * coef(leaf))`` with ``s`` a micro-batch's own power
    of two, so each micro-batch's gradient ``s * coef`` and their mean
    are exact in both packages however XLA contracts the products and
    sums, and no element of g + e can sit at an int8 rounding boundary
    in one package and not the other: its residuals are held bit for
    bit at every step (compression after the accumulation, with the
    scale, the error carried into the next step), its params and
    moments to 1e-5."""
    arch, jarch, model, params = _setup("dit")
    kw = dict(learning_rate=1e-3, warmup_steps=1, grad_accum=accum,
              ema_decay=ema, grad_compression=comp)
    tcfg = dataclasses.replace(arch.train, **kw)
    jcfg = dataclasses.replace(jarch.train, **kw)

    coefs = {id(p): torch.from_numpy(_coef(tuple(p.shape)))
             for p in model.parameters()}
    j_coefs = jax.tree_util.tree_leaves(_np_tree(jax_tree(
        model, lambda p: coefs[id(p)])))

    def j_fn(p, b, rng):
        if comp:
            loss = sum(jnp.sum(leaf * (b["s"][0] * c)) for leaf, c in
                       zip(jax.tree_util.tree_leaves(p), j_coefs))
        else:
            loss = j_loss("dit", jarch, p, b, jnp.float32)
        return loss, {"mse": loss}

    def t_fn(m, b, gen):
        if comp:
            loss = sum(torch.sum(p * (b["s"][0] * coefs[id(p)]))
                       for p in m.parameters())
            return loss, {"mse": loss.detach()}
        return workloads.diffusion_loss(arch, m, b, b["noise"], b["t"],
                                        compute_dtype=torch.float32)

    j_step = jax.jit(j_loop.make_train_step(j_fn, jcfg))
    t_step = train_loop.make_train_step(t_fn, tcfg)
    bar = {"loss": 1e-5, "mse": 1e-5, "grad_norm": 1e-5, "lr": 1e-5,
           "params": 1e-5, "moments": 1e-4}
    j_state = j_loop.train_state_init(params, jcfg)
    t_state = train_loop.train_state_init(model, tcfg)
    for i in range(3):
        nb = _batch("dit", arch, seed=10 + i)
        nb = {k: np.concatenate([v, v[::-1]]) for k, v in nb.items()}
        if comp:
            nb = {"s": np.float32(2.0) ** np.random.default_rng(i).integers(
                -2, 3, (4,)).astype(np.float32)}
        j_state, j_m = j_step(j_state, jax.tree_util.tree_map(
            jnp.asarray, nb), jax.random.PRNGKey(i))
        t_state, t_m = t_step(t_state, _torch_batch(nb), 0)
        for k in ("loss", "mse", "grad_norm", "lr"):
            assert _rel(float(t_m[k]), float(j_m[k])) <= bar[k], (i, k)
        if comp:
            err = dict(zip(coefs, t_state.compression.error))
            got_e = jax.tree_util.tree_leaves(_np_tree(jax_tree(
                model, lambda p: err[id(p)])))
            want_e = jax.tree_util.tree_leaves(j_state.compression.error)
            assert len(got_e) == len(want_e)
            for g, w in zip(got_e, want_e):
                np.testing.assert_array_equal(g, np.asarray(w))
            assert any(np.any(g) for g in got_e)
    tree = train_loop.state_tree(t_state)
    assert int(tree["opt"]["step"]) == int(j_state.opt.step) == 3
    got = _np_tree(tree["params"])
    assert _tree_rel(got, j_state.params) <= bar["params"]
    for k in ("mu", "nu"):
        assert _tree_rel(_np_tree(tree["opt"][k]), getattr(j_state.opt, k)) \
            <= bar["moments"]
    if ema:
        assert _tree_rel(_np_tree(tree["ema"]), j_state.ema) <= 1e-5
    else:
        assert "ema" not in tree and j_state.ema is None
    if not comp:
        assert "compression" not in tree and j_state.compression is None


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_train_and_checkpoint_configs_equal_the_reference(smoke):
    """Every arch's ``train`` (grad_accum 8 or 16 where the reference
    sets it) and ``checkpoint``, and ``apply_overrides`` reaching
    ``train.*`` as the reference's does."""
    from repro.config.base import apply_overrides as j_over
    from repro.configs import ALL_ARCHS as J_ALL
    from repro.configs import get_config as j_get
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import ALL_ARCHS, get_config

    assert sorted(ALL_ARCHS) == sorted(J_ALL)
    over = ["train.learning_rate=1e-3", "train.grad_accum=4",
            "train.remat=false", "checkpoint.keep=5"]
    for name in ALL_ARCHS:
        port = (get_smoke_config if smoke else get_config)(name)
        ref = (j_smoke if smoke else j_get)(name)
        for p, r in ((port, ref), (apply_overrides(port, over),
                                   j_over(ref, over))):
            assert dataclasses.asdict(p.train) == \
                dataclasses.asdict(r.train), name
            assert dataclasses.asdict(p.checkpoint) == \
                dataclasses.asdict(r.checkpoint), name
    assert get_config("flux-dev").train.grad_accum == 16


def test_grad_compression_is_refused():
    """``train.grad_compression`` was refused until the int8
    error-feedback compression was ported; now the state carries a
    float32 residual a parameter, zero at init, the checkpoint tree has
    the reference's ``compression/error/...`` paths, and a step moves
    the residual (the reference's tree from ``init_params`` of the same
    config)."""
    arch, jarch, model, params = _setup("dit")
    tcfg = dataclasses.replace(arch.train, grad_compression=True,
                               learning_rate=1e-3, warmup_steps=1)
    state = train_loop.train_state_init(model, tcfg)
    errs = state.compression.error
    assert [e.shape for e in errs] == [p.shape for p in model.parameters()]
    assert all(e.dtype == torch.float32 and not e.any() for e in errs)
    j_state = j_loop.train_state_init(
        params, dataclasses.replace(jarch.train, grad_compression=True))
    want = {k: np.asarray(v).shape for k, v in
            _flat_paths(j_state._asdict()).items()}
    got = {k: tuple(np.asarray(v).shape) for k, v in
           _flat_paths(train_loop.state_tree(state)).items()}
    assert got == want

    def t_fn(m, b, gen):
        return workloads.diffusion_loss(arch, m, b, b["noise"], b["t"],
                                        compute_dtype=torch.float32)

    step = train_loop.make_train_step(t_fn, tcfg)
    state, _ = step(state, _torch_batch(_batch("dit", arch, seed=3)), 0)
    assert any(e.any() for e in state.compression.error)


def _flat_paths(tree, prefix=""):
    """``path -> leaf`` of nested dicts, lists and NamedTuples, the
    checkpointers' ``/``-joined keys."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flat_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaln_closed_form_backward_matches_autograd(dtype):
    """The backward the CUDA Function runs, against autograd of the plain
    version, at a DiT-like (B, N, d) in f32 and bf16."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    x = (3 * torch.randn(2, 16, 72, generator=g) + 1).to(dt)
    shift, scale = (torch.randn(2, 72, generator=g).to(dt) for _ in "ab")
    gout = torch.randn(2, 16, 72, generator=g).to(dt)
    leaves = [t.clone().requires_grad_(True) for t in (x, shift, scale)]
    adaln_modulate_ref(*leaves).backward(gout)
    got = adaln_modulate_grads(x, scale, gout)
    bar = 1e-5 if dtype == "float32" else 1e-2
    for name, a, b in zip(("dx", "dshift", "dscale"), got, leaves):
        assert a.dtype == b.dtype, name
        assert _rel(a.float().numpy(), b.grad.float().numpy()) <= bar, name


def test_kernel_wrappers_refuse_operands_that_need_a_gradient():
    a = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="ripple_attention kernel has no "
                                           "backward.*q"):
        refuse_grad("ripple_attention", q=a, k=torch.zeros(2))
    with torch.no_grad():
        refuse_grad("ripple_attention", q=a)
    refuse_grad("ripple_attention", q=a.detach())


def test_served_forwards_build_no_graph():
    """With every parameter trainable (after ``train_state_init``), the
    serving entry points still build no autograd graph."""
    from repro_torch.configs import get_smoke_config as smoke
    from repro_torch.launch import serve as serve_lib

    arch = smoke("vit-l16")
    model = init_model(arch.model, device="cpu", zero_init=False)
    train_loop.train_state_init(model, arch.train)
    shape = dataclasses.replace(arch.shape("serve_b1"),
                                img_res=arch.model.img_res)
    out = workloads.classify_step(arch, shape, model)(
        torch.zeros(1, shape.img_res, shape.img_res, 3))
    assert out.grad_fn is None and not out.requires_grad

    arch = smoke("dit-b2")
    model = init_model(arch.model, device="cpu", zero_init=False)
    train_loop.train_state_init(model, arch.train)
    shape = serve_lib.serving_shape(arch, "gen_fast", smoke=True)
    fn, lat_shape = serve_lib.build_sampler(arch, shape, model,
                                            compute_dtype=torch.float32)
    lat = fn(torch.zeros((1,) + tuple(lat_shape)), None, [0])
    assert lat.grad_fn is None and not lat.requires_grad

    arch = smoke("gemma3-4b")
    model = init_model(arch.model, device="cpu", zero_init=False)
    train_loop.train_state_init(model, arch.train)
    shape = dataclasses.replace(arch.shape("prefill_32k"), seq_len=16)
    prefill, decode = workloads.lm_serve_steps(arch, shape, model)
    logits, cache = prefill(torch.zeros(1, 4, dtype=torch.long))
    logits2, _ = decode(torch.zeros(1, 1, dtype=torch.long), cache, 4)
    assert not any(t.requires_grad for t in (logits, logits2, *cache))
