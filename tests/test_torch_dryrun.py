"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
counts of a step on fake tensors equal the same counters' on the same step
run for real on CPU tensors; an LM train step's GEMM FLOPs are 6·N·D; at
1, 2 and 4 ranks the FSDP collectives and the per-rank state are
``distributed/fsdp.py``'s schedule; cells that need a model axis are not
runnable; the CLI and the hillclimb driver write their rows."""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.workloads import build_workload  # noqa: E402

torch.set_num_threads(2)


def _cut(arch, shape_name, **fields):
    """``arch`` with its shape ``shape_name`` cut to ``fields``."""
    shape = dataclasses.replace(arch.shape(shape_name), **fields)
    return dataclasses.replace(arch, shapes=tuple(
        shape if s.name == shape_name else s for s in arch.shapes))


def _lm(shape_name, name="gemma3-4b", overrides=(), **fields):
    """A smoke LM with its shape ``shape_name`` cut to ``fields``."""
    return _cut(apply_overrides(get_smoke_config(name), overrides),
                shape_name, **fields)


CELLS = {
    "train": lambda: (_lm("train_4k", global_batch=4, seq_len=32),
                      "train_4k"),
    "prefill": lambda: (_lm("prefill_32k", global_batch=2, seq_len=32),
                        "prefill_32k"),
    "decode": lambda: (_lm("decode_32k", global_batch=2, seq_len=32),
                       "decode_32k"),
    "classify": lambda: (_cut(get_smoke_config("vit-l16"), "serve_b128",
                              batch=2, img_res=32), "serve_b128"),
    "denoise": lambda: (_cut(apply_overrides(get_smoke_config("vdit-paper"),
                                             ("ripple.enabled=false",)),
                             "gen_512", img_res=64, steps=3), "gen_512"),
}


def _count_real(arch, shape_name):
    """The cell's step run twice on real CPU tensors: under
    ``FlopCounterMode`` (its FLOPs), then under the dry run's counters
    stacked as the dry run stacks them (bytes and peak)."""
    flops = FlopCounterMode(display=False)
    wl = build_workload(arch, shape_name, device="cpu")
    with flops:
        wl.fn(*wl.args)
    counter = dryrun.StepCounter()
    with dryrun.flop_counter(), counter:
        wl = build_workload(arch, shape_name, device="cpu")
        counter.start()
        wl.fn(*wl.args)
        counter.counting = False
    return flops.get_total_flops(), counter.nbytes, counter.peak


@pytest.mark.parametrize("kind", list(CELLS))
def test_fake_counts_equal_the_real_steps(kind):
    arch, shape_name = CELLS[kind]()
    assert arch.shape(shape_name).kind == {"denoise": "generate"}.get(kind, kind)
    cell = dryrun.run_cell(arch.name, shape_name, arch=arch, verbose=False)
    flops, nbytes, peak = _count_real(arch, shape_name)
    assert cell.kernel_calls == {} and cell.kernel_bytes == 0
    assert flops > 0 and nbytes > 0
    assert cell.report.hlo_flops == flops
    assert cell.report.hlo_bytes == nbytes
    # The fake run also allocates the few scalars that torch.tensor()
    # makes outside the dispatcher on real tensors.
    assert abs(cell.report.peak_mem_bytes / peak - 1) < 1e-3


@pytest.mark.parametrize("name", ["gemma3-4b", "qwen2-moe-a2.7b"])
def test_lm_train_gemm_flops_are_6nd(name):
    """Remat off: the counted GEMM FLOPs are 6·N·D within 10%, and within
    1% of 6·N_gemm·D plus the attention core's 12·S·H·hd a token and layer
    (forward and backward), N_gemm the weight matrices less the untied
    embedding table (a gather, no GEMM; with the attention core, the 10%).
    The port's trainer runs the dense MoE, every expert on every token, so
    for the MoE N is the total, not the active count, and the useful
    ratio 6·N_active·D / FLOPs is about N_active / N."""
    from repro_torch.models.transformer_lm import TransformerLM

    arch = _lm("train_4k", name, ("train.remat=false",), global_batch=4,
               seq_len=8)
    cell = dryrun.run_cell(name, "train_4k", arch=arch, verbose=False)
    m = arch.model
    model = TransformerLM(m, device="meta", dtype=torch.float32)
    n = rl.param_count(m)
    n_gemm = sum(p.numel() for p in model.parameters() if p.dim() >= 2) \
        - (0 if m.tie_embeddings else m.vocab_size * m.d_model)
    tokens = 4 * 8
    attn = 12 * 8 * m.num_heads * m.resolved_head_dim * m.num_layers * tokens
    flops = cell.report.hlo_flops
    assert abs(flops / (6 * n * tokens) - 1) <= 0.10
    assert abs(flops / (6 * n_gemm * tokens + attn) - 1) <= 0.01
    active = rl.active_params_lm(m)
    assert cell.report.model_flops == 6 * active * tokens
    assert math.isclose(cell.report.useful_ratio, 6 * active * tokens / flops)


def _schedule(arch, ranks):
    """fsdp.py's schedule by arithmetic, for one step of ``arch``'s smoke
    LM train cell on ``ranks`` ranks: (bytes on the wire by collective,
    per-rank float32 state bytes: parameter pieces and two moments)."""
    from repro_torch.distributed.fsdp import block_units
    from repro_torch.distributed.sharding import param_rules, spec_from_axes
    from repro_torch.models.params import param_axes
    from repro_torch.models.transformer_lm import TransformerLM

    model = TransformerLM(arch.model, device="meta", dtype=torch.float32)
    params = list(model.parameters())
    mesh = dryrun._rank_mesh(ranks)
    rules = param_rules(mesh)
    sharded = [any(e == "data" or (isinstance(e, tuple) and "data" in e)
                   for e in spec_from_axes(ax, rules, tuple(p.shape), mesh))
               for p, ax in zip(params, param_axes(model))]
    in_block = {id(p) for b in block_units(model) for p in b.parameters()}
    accum = arch.train.grad_accum
    nb = [4 * p.numel() for p in params]
    whole = sum(b for b, s in zip(nb, sharded) if s)
    root = sum(b for b, s, p in zip(nb, sharded, params)
               if s and id(p) not in in_block)
    repl = sum(b for b, s in zip(nb, sharded) if not s)
    f = (ranks - 1) / ranks
    # The root gathered once a step, a block twice a micro-batch (its
    # forward, its backward); the clip norm's per-rank norms (4 bytes a
    # parameter tensor) gathered once.
    gather = f * (root + 2 * accum * (whole - root)) \
        + f * ranks * 4 * len(params)
    # Each whole gradient reduce-scattered, each replicated one all-reduced,
    # once a micro-batch; the means of the loss and its two metrics (nll,
    # aux) all-reduced once.
    scatter = f * accum * whole
    reduce = 2 * f * (accum * repl + 3 * 4)
    coll = {"all-gather": gather, "reduce-scatter": scatter,
            "all-reduce": reduce} if ranks > 1 else {}
    state = 3 * sum(b // ranks if s else b for b, s in zip(nb, sharded))
    return coll, state


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_fsdp_collectives_and_state_are_the_schedule(ranks):
    arch = _lm("train_4k", global_batch=8, seq_len=16)
    cell = dryrun.run_cell(arch.name, "train_4k", arch=arch, ranks=ranks,
                           verbose=False)
    coll, state = _schedule(arch, ranks)
    got = cell.report.collective_breakdown
    assert set(got) == set(coll)
    for k, v in coll.items():
        assert got[k] == int(v), k
    # The state at the step's start: the float32 pieces and moments, and
    # the batch (tokens and targets, 8 x 16 int64 each).
    assert cell.state_bytes == state + 2 * 8 * 16 * 8
    assert cell.report.collective_s == \
        sum(int(v) for v in coll.values()) / rl.NVLINK_BYTES_PER_S
    if ranks > 1:
        one = dryrun.run_cell(arch.name, "train_4k", arch=arch,
                              verbose=False)
        assert cell.report.peak_mem_bytes < one.report.peak_mem_bytes


@pytest.mark.parametrize("variant,kind", [
    ({"train.seq_parallel": "true"}, "train"),
    ({"decode_replicate_heads": "true"}, "decode"),
    ({"decode_no_fsdp": "true"}, "decode")])
def test_cells_needing_a_model_axis_are_not_runnable(variant, kind):
    """The decode variants are not runnable; ``train.seq_parallel`` (seq
    on the model axis) is costed on a model axis, here the smoke qwen3's
    train step at 4 ranks of (data 2, model 2)."""
    arch = apply_overrides(get_config("qwen3-32b"),
                           tuple(f"{k}={v}" for k, v in variant.items()))
    shape = next(s.name for s in arch.shapes if s.kind == kind)
    if kind == "train":
        small = _lm(shape, "qwen3-32b", tuple(f"{k}={v}" for k, v in
                                              variant.items()),
                    global_batch=4, seq_len=32)
        cell = dryrun.run_cell(small.name, shape, arch=small, ranks=4,
                               model_axis=2, verbose=False)
        assert cell.row()["mesh"] == "2x2"
        assert "model reduce-scatter" in cell.report.collective_breakdown
        return
    with pytest.raises(dryrun.NotRunnable, match="model axis|whole weights"):
        dryrun.run_cell("qwen3-32b", shape, arch=arch)


def test_two_d_pieces_are_the_whole_over_four():
    """At 4 ranks of (data 2, model 2) a parameter whose spec puts one dim
    on data and another on model holds a quarter of the whole on each
    rank; the state at the step's start is every piece's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = _lm("train_4k", "qwen2-moe-a2.7b", global_batch=4, seq_len=32)
    with dryrun._fake_ranks(4, 2) as mesh, FakeTensorMode():
        wl = build_workload(arch, "train_4k", mesh, device="cpu")
        sh = wl.args[0].shards
        both = [i for i in range(len(sh.params))
                if sh.dims[i] is not None and sh.mdims[i] is not None]
        assert len(both) > 10
        for i in both:
            assert 4 * sh.local[i].numel() == math.prod(sh.shapes[i])
        whole = sum(math.prod(s) for s in sh.shapes)
        held = sum(x.numel() for x in sh.local)
        assert whole / 4 <= held < whole / 2


def test_model_axis_bytes_are_their_formula():
    """The smoke gemma3-4b's step at (data 2, model 2), remat on: each of
    the T = 2 x 32 tokens' (T, d) bfloat16 activations is all-reduced over
    the model group once at the embedding, twice a layer in the forward,
    once more in remat's recomputation (the attention's output: the
    recomputation stops once what the backward needs is back, and the
    MLP's summed output is not), twice a layer in the backward (the
    regions' inputs), and once at the head's input in the backward; the
    cross entropy combines the max, the sum of exponentials and the
    target logit (T float32 each); the q/k norm scales' float32
    gradients are summed; at model 2 the ring moves 2(M-1)/M = 1 of
    each."""
    arch = _lm("train_4k", global_batch=4, seq_len=32)
    m = arch.model
    cell = dryrun.run_cell(arch.name, "train_4k", arch=arch, ranks=4,
                           model_axis=2, verbose=False)
    T, L, hd = 2 * 32, m.num_layers, m.resolved_head_dim
    want = (1 + 5 * L + 1) * T * m.d_model * 2 + 3 * T * 4 + L * 2 * hd * 4
    got = cell.report.collective_breakdown
    assert got["model all-reduce"] == want
    assert "model all-gather" not in got  # whole heads a rank at model 2
    assert cell.row()["mesh"] == "2x2" and cell.report.chips == 4


def test_dit_model_axis_all_reduces_are_their_formula():
    """The smoke dit-xl2's train step at (data 2, model 2), 4 images of 4
    x 4 tokens, 2 rows a rank: the timestep MLP's region sums its (2, d)
    bfloat16 output once (its input takes no gradient), each block's
    attention and MLP regions their (2 x 16, d) outputs in the forward
    and their inputs' gradients in the backward; whole heads, MLP columns
    and rows a rank at model 2, so nothing is gathered over the model
    group; at model 2 the ring moves 2(M-1)/M = 1 of each; the adaLN
    kernel 2 a block and the final one."""
    arch = _cut(get_smoke_config("dit-xl2"), "train_256", batch=4,
                img_res=64)
    m = arch.model
    cell = dryrun.run_cell(arch.name, "train_256", arch=arch, ranks=4,
                           model_axis=2, verbose=False)
    rows, tokens = 2, 16
    want = (rows * m.d_model + m.num_layers * 4 * rows * tokens
            * m.d_model) * 2
    got = cell.report.collective_breakdown
    assert got["model all-reduce"] == want
    assert "model all-gather" not in got
    assert cell.kernel_calls == {"adaln": 2 * m.num_layers + 1}


def _one_layer_qwen3():
    """qwen3-32b at its published widths, cut to one layer and to one
    train_4k sequence a data rank of the 16 x 16 mesh (one micro-batch):
    the cell the tests cost on the production mesh in seconds."""
    full = get_config("qwen3-32b")
    return _cut(dataclasses.replace(full, model=dataclasses.replace(
        full.model, num_layers=1)), "train_4k", global_batch=16)


def test_qwen3_train_on_the_production_mesh_gives_a_row(tmp_path, capsys):
    """``--ranks 256 --model-axis 16`` (the reference's 16 x 16 mesh)
    costs qwen3-32b's train_4k, here cut (``_one_layer_qwen3``): a row
    with the model axis's collectives, among them the all-gathers of the kv
    pieces that end mid-head (8 x 128 over 16: 64 columns)."""
    import repro_torch.configs as configs

    out = tmp_path / "rows.jsonl"
    cut = _one_layer_qwen3()
    orig = dryrun.get_config
    dryrun.get_config = lambda name: cut if name == "qwen3-32b" else orig(name)
    try:
        rc = dryrun.main(["--arch", "qwen3-32b", "--shape", "train_4k",
                          "--ranks", "256", "--model-axis", "16", "--json",
                          str(out)])
    finally:
        dryrun.get_config = orig
    assert rc == 0 and configs.get_config("qwen3-32b").model.num_layers == 64
    row = json.loads(out.read_text())
    assert row["mesh"] == "16x16" and row["ranks"] == 256
    assert {"model all-reduce", "model all-gather", "all-gather",
            "reduce-scatter"} <= set(row["collectives"])
    assert row["peak_mem_gb"] > 0
    assert "1/1 cells passed" in capsys.readouterr().out


@pytest.mark.parametrize("name,shape,why", [
    ("qwen3-32b", "decode_32k", "ROADMAP §1 item 5"),
    ("qwen3-32b", "prefill_32k", "ROADMAP §1 item 5"),
    ("unet-sd15", "train_256", "ROADMAP §1 item 4b"),
    ("efficientnet-b7", "cls_224", "ROADMAP §1 item 4b")])
def test_serving_and_non_lm_train_on_a_model_axis_are_not_runnable(
        name, shape, why):
    arch = get_config(name)
    if shape not in [s.name for s in arch.shapes]:
        shape = next(s.name for s in arch.shapes if s.kind == "train")
    with pytest.raises(dryrun.NotRunnable, match=why):
        dryrun.run_cell(name, shape, ranks=256, model_axis=16)


def test_cli_prints_a_row_and_the_passed_line(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    rc = dryrun.main(["--arch", "dit-b2", "--shape", "gen_fast", "--json",
                      str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "dry-run complete: 1/1 cells passed" in text
    row = json.loads(out.read_text())
    assert row["arch"] == "dit-b2" and row["shape"] == "gen_fast"
    # One denoiser forward of dit-b2 (12 layers): 2 adaLN calls a block and
    # the final one, 2 snaps and 1 ripple call a block.
    assert row["kernel_calls"] == {"adaln": 25, "fused_reuse": 24,
                                   "ripple_attention": 12}
    assert row["steps_multiplier"] == get_config("dit-b2").shape(
        "gen_fast").steps
    assert math.isclose(row["bound_s"], max(row["compute_s"], row["memory_s"]))


def test_hillclimb_writes_not_runnable_rows(tmp_path, monkeypatch):
    """The qwen3 cells are costed on the reference's 16 x 16 mesh (here
    cut by ``_one_layer_qwen3``, so the test stays short); the phi decode
    cells are written as not runnable, with their reason."""
    monkeypatch.chdir(tmp_path)
    cut = _one_layer_qwen3()
    monkeypatch.setattr(hillclimb, "get_config", lambda name: cut
                        if name == "qwen3-32b" else get_config(name))
    hillclimb.main(["qwen3_sp", "qwen3_sp_dots", "phi_decode", "phi_nofsdp"])
    rows = [json.loads(ln) for ln in
            (tmp_path / "hillclimb.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in rows] == [
        "qwen3.train_4k.seq_parallel", "qwen3.train_4k.sp+dots",
        "phi.decode_32k.replicate_heads", "phi.decode_32k.no_fsdp"]
    for r in rows[:2]:
        assert "not_runnable" not in r and r["mesh"] == "16x16"
        assert "model reduce-scatter" in r["collectives"]
    assert all("ROADMAP" in r["not_runnable"] for r in rows[2:])
