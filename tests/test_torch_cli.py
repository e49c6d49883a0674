"""The port's training entry points (nans_clip_tpu_torch/training/main.py,
params.py, train_lora.py::main, utils/checkpoint.py, eval/model_io.py,
bench.py) on the CPU, against the JAX package's CLIs at tiny_config in fp32.

Both trainers start from the same weights (the JAX init at --seed, carried
across by state_dict_from_jax_params through a monkeypatch of the port's
build_model) with the text tower's dropout at 0 in both tiny_configs (the
two packages draw different random bits), and read the same split: the JAX
loader through its PIL reader (native=False), which the port's default
decoder equals bit for bit (tests/test_torch_data.py). JAX runs 8 CPU
devices (tests/conftest.py), so its --batch-size 2 is a global batch of 16,
the port's --batch-size 16.

Tolerances: each step's loss within 1e-5; parameters (adapters) within
tests/test_torch_train.py's bound: 1e-6 plus, a step, 2 * lr where the
gradient is below 1e-6 in magnitude, else lr * min(2, 4 r) for the relative
difference r between the port's gradient and the one the JAX step took
(Adam's sensitivity to its gradient), summed over the steps. A resumed run
on the CPU is bit-equal to an uninterrupted one."""

import csv
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.data import dataset as jdataset
from nans_clip_tpu.data import npack as jnpack
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.models import lora as jlora
from nans_clip_tpu.parallel import clip_loss as jclip_loss
from nans_clip_tpu.training import main as jmain
from nans_clip_tpu.training import params as jparams
from nans_clip_tpu.training import train_lora as jtl
from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.data.npack import NPackWriter, encode_pair
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.models.lora import _leaves, load_lora
from nans_clip_tpu_torch.training import main as tmain
from nans_clip_tpu_torch.training import params as tparams
from nans_clip_tpu_torch.training import train_lora as ttl
from nans_clip_tpu_torch.training import trainer
from nans_clip_tpu_torch.utils import checkpoint as ckpt
from nans_clip_tpu_torch.utils.torch_interop import lora_from_jax, state_dict_from_jax_params

from test_torch_train import _as_port, _jax_grads, _no_dropout, _port_cfg

torch.set_num_threads(2)

LR = 1e-4
SEED = 123


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """32 pairs of seeded noise JPEGs, 40 pixels (decoded to tiny_config's 32)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cli_split")
    rs = np.random.RandomState(0)
    with NPackWriter(str(root / "imgs.npack")) as wi, \
            NPackWriter(str(root / "pairs.npack")) as wp:
        for i in range(32):
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                buf, format="JPEG")
            wi.put(i, buf.getvalue())
            wp.put(i, encode_pair(i, i, f"图{i}"))
    return str(root)


_TINY = jconfigs.tiny_config


def _jax_tiny():
    return _no_dropout(_TINY())


def _common(split, logs, name):
    return ["--train-data", split, "--tiny-model", "--precision", "fp32", "--attn-impl", "xla",
            "--lr", str(LR), "--warmup", "2", "--log-interval", "1", "--logs", logs,
            "--name", name, "--num-workers", "2", "--seed", str(SEED)]


def _jax_reader(monkeypatch):
    monkeypatch.setattr(jdataset, "NPackReader",
                        lambda path: jnpack.NPackReader(path, native=False))


@pytest.fixture(scope="module")
def jax_run(split, tmp_path_factory):
    """One epoch of the JAX CLI (2 steps): each step's loss, and what each
    step took (its parameters, images, texts and key), and the final
    parameters."""
    logs = str(tmp_path_factory.mktemp("jax_logs"))
    steps = []
    orig = jmain.make_train_step

    def recording(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, images, texts, rng):
            taken = (jax.tree.map(np.asarray, state.params), np.asarray(images),
                     np.asarray(texts), rng)
            state, metrics = step(state, images, texts, rng)
            steps.append((*taken, float(metrics["loss"])))
            return state, metrics
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfigs, "tiny_config", _jax_tiny)
        mp.setattr(jmain, "make_train_step", recording)
        mp.setattr(jmain, "save_checkpoint", lambda *a, **kw: None)   # not compared here
        _jax_reader(mp)
        state = jmain.main(_common(split, logs, "jax") + ["--batch-size", "2",
                                                          "--max-epochs", "1"])
    return steps, state


def _jax_init_build_model(args):
    """The port's build_model, from the JAX init at --seed (no dropout)."""
    jcfg = _jax_tiny()
    cfg = _port_cfg(jcfg)
    params, _ = jclip.init_clip(jax.random.PRNGKey(args.seed), jcfg)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return cfg, module, ModelOptions(attn_impl=args.attn_impl, deterministic=False)


def _slack(slack, name, g, gt, lr):
    r = (g - gt).abs() / gt.abs().clamp_min(1e-30)
    slack[name] = slack.get(name, 0.0) + torch.where(gt.abs() < 1e-6, 2 * lr,
                                                     lr * torch.clamp(4 * r, max=2.0))
    return slack[name]


def test_trainer_cli_matches_jax(split, tmp_path, jax_run, monkeypatch):
    jsteps, jstate = jax_run
    grads = []
    orig = tmain.make_train_step

    def recording(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, images, texts, generator):
            state, metrics = step(state, images, texts, generator)
            grads.append({n: p.grad.clone() for n, p in state.module.named_parameters()})
            return state, metrics
        return wrapped

    monkeypatch.setattr(tmain, "build_model", _jax_init_build_model)
    monkeypatch.setattr(tmain, "make_train_step", recording)
    logs = str(tmp_path / "logs")
    state = tmain.main(_common(split, logs, "port") + ["--platform", "cpu", "--batch-size", "16",
                                                       "--max-epochs", "1"])
    assert state.step == len(jsteps) == 2
    with open(os.path.join(logs, "port", "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]
    assert len(losses) == 2
    jcfg = _jax_tiny()
    cfg = _port_cfg(jcfg)
    options_j = JOptions(attn_impl="xla", deterministic=False)
    grads_j = jax.jit(lambda p, im, tx, rng: _jax_grads(p, jcfg, options_j, im, tx, rng))
    slack = {}
    for i, (params, images, texts, rng, loss) in enumerate(jsteps):
        assert abs(losses[i] - loss) <= 1e-5, i
        taken = _as_port(grads_j(params, images, texts, rng), cfg)
        for name, g in grads[i].items():
            _slack(slack, name, g, taken[name], LR)
    want = _as_port(jstate.params, cfg)
    for name, p in state.module.named_parameters():
        assert bool(((p.detach() - want[name]).abs() <= 1e-6 + slack[name]).all()), name


def test_resumed_run_is_bit_equal(split, tmp_path):
    """Text dropout (tiny_config's 0.1) and augmentation on: two steps
    straight, against one step, a step checkpoint, and a resume from it."""
    run = lambda name, *extra: tmain.main(
        _common(split, str(tmp_path), name) + ["--platform", "cpu", "--batch-size", "16",
                                               "--use-augment", *extra])
    straight = run("straight", "--max-steps", "2")
    run("resumed", "--max-steps", "1", "--save-step-frequency", "1")
    ckpt_dir = tmp_path / "resumed" / "checkpoints"
    with open(ckpt_dir / "step_1.meta.json") as f:
        assert json.load(f) == {"epoch": 0, "step": 1, "name": "resumed", "epoch_batch": 1,
                                "epoch_samples": 16}
    resumed = run("resumed", "--max-steps", "2", "--resume", "step_1")
    assert straight.step == resumed.step == 2
    for (n, a), b in zip(straight.module.named_parameters(), resumed.module.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    loss = lambda name: [r["loss"] for r in map(json.loads, open(tmp_path / name / "metrics.jsonl"))
                         if r["kind"] == "train"]
    assert loss("straight") == loss("resumed")


def _params(state):
    return [p.detach() for p in state.module.parameters()]


@pytest.mark.parametrize("k", [2, 3])
def test_steps_per_call_matches_single(split, tmp_path, k):
    """--steps-per-call K runs K single steps a group: the trajectory of K =
    1, with an epoch tail shorter than K at K = 3 and a --max-steps trim."""
    run = lambda name, *extra: tmain.main(
        _common(split, str(tmp_path), name) + ["--platform", "cpu", "--batch-size", "16",
                                               "--max-epochs", "2", *extra])
    ref, got = run("k1"), run("k", "--steps-per-call", str(k))
    assert ref.step == got.step == 4
    assert all(torch.equal(a, b) for a, b in zip(_params(ref), _params(got)))
    assert run("trim", "--steps-per-call", str(k), "--max-steps", "3").step == 3


def test_preemption_checkpoints_and_returns(split, tmp_path, monkeypatch):
    """SIGTERM during a step: the step finishes, preempt_step_1 is saved with
    its data offset, main returns; resuming from it ends where an
    uninterrupted run ends."""
    import signal
    orig = tmain.make_train_step

    def preempted(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, *args):
            out = step(state, *args)
            os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    run = lambda name, *extra: tmain.main(
        _common(split, str(tmp_path), name) + ["--platform", "cpu", "--batch-size", "16",
                                               "--max-epochs", "1", *extra])
    straight = run("straight")
    before = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as mp:
        mp.setattr(tmain, "make_train_step", preempted)
        state = run("preempted")
    assert state.step == 1
    assert signal.getsignal(signal.SIGTERM) is before      # the handlers are restored
    d = tmp_path / "preempted" / "checkpoints"
    with open(d / "preempt_step_1.meta.json") as f:
        assert json.load(f)["epoch_batch"] == 1
    resumed = run("preempted", "--resume", "preempt_step_1")
    assert resumed.step == 2
    assert all(torch.equal(a, b) for a, b in zip(_params(straight), _params(resumed)))


def test_profile_steps_write_a_trace(split, tmp_path):
    logs = str(tmp_path)
    tmain.main(_common(split, logs, "prof") + ["--platform", "cpu", "--batch-size", "16",
                                               "--max-steps", "2", "--profile-steps", "0:1"])
    with open(os.path.join(logs, "prof", "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert events
    names = {e.get("name") for e in events}
    assert {"cli.train_step", "train.step", "train.prepare", "train.forward", "train.backward",
            "train.optimizer", "model.encode_image", "model.encode_text",
            "model.cast"} <= names, sorted(n for n in names if n and "." in n)


def test_epochs_checkpoints_and_auto_resume(split, tmp_path):
    """The JAX CLI's cycle (tests/test_main_cli.py): an epoch, its
    checkpoint and LATEST, then an auto-resume that trains the next epoch;
    validation weighted by samples; the .pt export and the checkpoint
    directory both load for eval with the trained weights."""
    from nans_clip_tpu_torch.api import model_from_config
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    logs = str(tmp_path / "logs")
    common = _common(split, logs, "cycle") + ["--platform", "cpu", "--batch-size", "16",
                                              "--val-data", split, "--valid-batch-size", "8",
                                              "--save-torch-format"]
    state = tmain.main(common + ["--max-epochs", "1"])
    assert state.step == 2
    d = os.path.join(logs, "cycle", "checkpoints")
    assert ckpt.latest_exists(d) and open(os.path.join(d, "LATEST")).read() == "epoch1"
    with open(os.path.join(d, "epoch1.meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 2, "name": "cycle", "epoch_batch": 0,
                                "epoch_samples": 0}
    state2 = tmain.main(common + ["--max-epochs", "2"])
    assert state2.step == 4 and os.path.isdir(os.path.join(d, "epoch2"))
    with open(os.path.join(logs, "cycle", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    valid = [r for r in records if r["kind"] == "valid"]
    assert [r["samples"] for r in valid] == [32, 32] and [r["step"] for r in valid] == [2, 4]
    tiny = configs.tiny_config()
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = state2.module.encode_image(torch.from_numpy(images), ModelOptions())
    for model in (load_eval_model("", "", os.path.join(d, "epoch2"), "fp32", cfg=tiny,
                                  device="cpu"),
                  model_from_config(tiny, os.path.join(d, "epoch2.pt"), device="cpu")):
        assert torch.equal(model.encode_image(images), want.detach())
    meta = torch.load(os.path.join(d, "epoch2.pt"), weights_only=True)
    assert (meta["epoch"], meta["step"], meta["name"]) == (2, 4, "cycle")


def test_pretrained_towers_merge_with_the_jax_filters(tmp_path):
    """--clip-weight-path gives visual.* and logit_scale, --bert-weight-path
    bert.* but the pooler (nans_clip_tpu/utils/torch_interop.py:310-330);
    text_projection keeps the seeded init."""
    tiny = configs.tiny_config()
    clip_m = build_clip(tiny, "cpu", torch.Generator().manual_seed(1))
    bert_m = build_clip(tiny, "cpu", torch.Generator().manual_seed(2))
    bert_sd = {k: v for k, v in bert_m.state_dict().items() if k.startswith("bert")}
    bert_sd["bert.pooler.dense.weight"] = torch.zeros(64, 64)
    torch.save({"state_dict": clip_m.state_dict()}, tmp_path / "clip.pt")
    torch.save({"state_dict": bert_sd}, tmp_path / "bert.pt")
    args = tparams.parse_args(["--tiny-model", "--seed", "3", "--clip-weight-path",
                               str(tmp_path / "clip.pt"), "--bert-weight-path",
                               str(tmp_path / "bert.pt")])
    cfg, module, options = tmain.build_model(args)
    seeded = build_clip(tiny, "cpu", torch.Generator().manual_seed(3))
    assert cfg.name == "tiny" and not options.deterministic
    for name, p in module.state_dict().items():
        src = clip_m if name.startswith("visual") or name == "logit_scale" else \
            bert_m if name.startswith("bert") else seeded
        assert torch.equal(p, src.state_dict()[name]), name


# The flags the CLI refuses with a message: --tp 2 or --pp 2 on one process
# (no grid of data x 2), --distributed (also with --fsdp) without a launcher's
# rendezvous, --tp with --pp; tests/test_torch_dp_cli.py runs --distributed,
# --tp and --fsdp across ranks, tests/test_torch_pp_cli.py --pp.
REFUSED = {
    "tp": (["--tp", "2"], "grid of data x 2"),
    "pp": (["--pp", "2"], "grid of data x 2"),
    "fsdp": (["--fsdp", "--distributed"], "rendezvous"),
    "distributed": (["--distributed"], "rendezvous"),
    "tp-x-pp": (["--tp", "2", "--pp", "2"], "exclusive"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_flags_are_refused(case, tmp_path):
    flags, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        tmain.main(["--train-data", str(tmp_path), "--platform", "cpu", "--logs",
                    str(tmp_path), *flags])


def test_grad_checkpointing_reaches_the_options(tmp_path):
    """--grad-checkpointing is ``ModelOptions.remat`` of the train step (off
    without it); --pp and --pp-microbatches are parsed with the JAX CLI's
    defaults."""
    args = tparams.parse_args(["--tiny-model", "--grad-checkpointing"])
    assert tmain.build_model(args)[2].remat
    args = tparams.parse_args(["--tiny-model"])
    assert not tmain.build_model(args)[2].remat
    assert (args.pp, args.pp_microbatches) == (1, 0)


def test_rn50_trains_and_resumes_bit_equal(split, tmp_path, monkeypatch):
    """--vision-model RN50 --text-model RBT3-chinese, the tiny RN config
    (tests/test_torch_resnet.py::tiny_rn_config) standing in for the
    published widths, with --mask-ratio 0.5, which a ResNet ignores (the JAX
    CLI's note is logged): two steps straight against one step, a step
    checkpoint and a resume from it; the parameters, the BatchNorm running
    statistics, the Adam moments and the losses bit-equal, and the
    statistics moved."""
    import glob

    from test_torch_resnet import serve_tiny_rn, tiny_rn_config

    serve_tiny_rn(monkeypatch, tmain.configs)
    run = lambda name, *extra: tmain.main(
        ["--train-data", split, "--vision-model", "RN50", "--text-model", "RBT3-chinese",
         "--precision", "fp32", "--attn-impl", "xla", "--lr", str(LR), "--warmup", "2",
         "--log-interval", "1", "--logs", str(tmp_path), "--name", name, "--num-workers", "2",
         "--seed", str(SEED), "--platform", "cpu", "--batch-size", "8", "--mask-ratio", "0.5",
         *extra])
    straight = run("straight", "--max-steps", "2")
    assert straight.module.cfg == tiny_rn_config()
    log = open(glob.glob(str(tmp_path / "straight" / "out_*.log"))[0]).read()
    assert "only functions for ViT towers" in log
    run("resumed", "--max-steps", "1", "--save-step-frequency", "1")
    resumed = run("resumed", "--max-steps", "2", "--resume", "step_1")
    assert straight.step == resumed.step == 2
    a, b = straight.module.state_dict(), resumed.module.state_dict()
    assert set(a) == set(b) and any("running_var" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    init = build_clip(tiny_rn_config(), "cpu", torch.Generator().manual_seed(SEED))
    key = "visual.bn1.running_mean"
    assert not torch.equal(a[key], init.state_dict()[key])
    for x, y in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(x[k], y[k]) for k in ("exp_avg", "exp_avg_sq"))
    loss = lambda name: [r["loss"] for r in map(json.loads, open(tmp_path / name / "metrics.jsonl"))
                         if r["kind"] == "train"]
    assert loss("straight") == loss("resumed") and len(loss("straight")) == 2


def test_lora_refuses_a_resnet(tmp_path, monkeypatch):
    """LoRA targets transformer towers: train_lora refuses an RN50 model as
    the JAX CLI does (nans_clip_tpu/training/train_lora.py:141)."""
    from nans_clip_tpu_torch.eval import model_io
    from test_torch_resnet import serve_tiny_rn, tiny_rn_config

    serve_tiny_rn(monkeypatch, model_io)
    ckpt = str(tmp_path / "rn.pt")
    torch.save({"state_dict": build_clip(tiny_rn_config(), "cpu",
                                         torch.Generator().manual_seed(0)).state_dict()}, ckpt)
    with pytest.raises(SystemExit, match="LoRA targets transformer towers"):
        ttl.main(["--train-data", str(tmp_path), "--resume", ckpt, "--vision-model", "RN50",
                  "--text-model", "RBT3-chinese", "--platform", "cpu",
                  "--output-dir", str(tmp_path / "out")])


def test_params_take_the_jax_flags_and_the_card_is_the_default(tmp_path):
    argv = ["--train-data", "d", "--batch-size", "8", "--accum-freq", "2", "--use-augment",
            "--vision-model", "ViT-L-14", "--save-step-frequency", "5"]
    ours, theirs = vars(tparams.parse_args(argv)), vars(jparams.parse_args(argv))
    assert ours.pop("platform") == "cuda"
    theirs.pop("platform")
    assert ours.pop("dist_timeout") == 600.0   # the port's, a collective's bound across ranks
    assert ours == theirs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--platform cpu"):
            tmain.main(["--train-data", str(tmp_path), "--logs", str(tmp_path)])
        with pytest.raises(RuntimeError, match="--platform cpu"):
            ttl.main(["--train-data", str(tmp_path), "--tiny-model"])
    assert trainer.step_seeds(1, 2) == trainer.step_seeds(1, 2) != trainer.step_seeds(1, 3)


# -- checkpoints: the cases of tests/test_checkpoint.py ----------------------

def _state(seed, tcfg=trainer.TrainConfig(max_steps=10)):
    module = build_clip(configs.tiny_config(), "cpu", torch.Generator().manual_seed(seed))
    return trainer.create_train_state(module, tcfg, device="cpu")


def _one_step(state, tcfg=trainer.TrainConfig(max_steps=10, lr=1e-3)):
    rs = np.random.RandomState(0)
    images = rs.randn(4, 32, 32, 3).astype(np.float32)
    texts = np.zeros((4, 52), np.int64)
    texts[:, 0], texts[:, 1:5], texts[:, 5] = 101, rs.randint(1000, 20000, (4, 4)), 102
    step = trainer.make_train_step(state.module.cfg, tcfg, ModelOptions(deterministic=False))
    return step(state, images, texts, 0)[0], (images, texts, step)


@pytest.fixture()
def saved_state(tmp_path):
    state, _ = _one_step(_state(0))
    state.step = 7
    d = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(d, "epoch3", state, {"epoch": 3, "step": 7, "name": "t"})
    return d, state


def test_checkpoint_latest_pointer_and_restore(saved_state):
    d, state = saved_state
    assert ckpt.latest_exists(d) and ckpt.resolve_tag(d, "epoch_latest") == "epoch3"
    restored, meta = ckpt.restore_checkpoint(d, "epoch_latest", _state(1))
    assert meta == {"epoch": 3, "step": 7, "name": "t"} and restored.step == 7
    for (n, a), b in zip(restored.module.named_parameters(), state.module.parameters()):
        assert torch.equal(a, b), n
    assert restored.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()
    assert restored.optimizer.param_groups[0]["count"] == 1


def test_checkpoint_reset_optimizer_keeps_the_fresh_one(saved_state):
    d, state = saved_state
    template = _state(1)
    restored, _ = ckpt.restore_checkpoint(d, "epoch3", template, reset_optimizer=True)
    assert not restored.optimizer.state and "count" not in restored.optimizer.param_groups[0]
    assert restored.step == 7
    assert torch.equal(restored.module.text_projection, state.module.text_projection)


def test_checkpoint_missing_raises_unless_opted_out(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), "epoch_latest", _state(0))
    _, meta = ckpt.restore_checkpoint(str(tmp_path / "none"), "epoch_latest", _state(0),
                                      missing_ok=True)
    assert meta is None


def test_checkpoint_reset_optimizer_survives_optimizer_change(saved_state):
    """An AdamW state restored into a run with bf16 Adam moments
    (CompactAdamW): with --reset-optimizer the parameters come back; without
    it the mismatch raises and names the flag."""
    d, state = saved_state
    compact = trainer.TrainConfig(max_steps=10, adam_state_dtype="bfloat16")
    restored, _ = ckpt.restore_checkpoint(d, "epoch3", _state(1, compact), reset_optimizer=True)
    assert isinstance(restored.optimizer, trainer.CompactAdamW)
    for a, b in zip(restored.module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="--reset-optimizer"):
        ckpt.restore_checkpoint(d, "epoch3", _state(1, compact))


def test_compact_adam_state_round_trips(tmp_path):
    """bf16 moments come back in bf16, and the next step is bit-equal to
    one that never went through the checkpoint."""
    tcfg = trainer.TrainConfig(max_steps=10, lr=1e-3, adam_state_dtype="bfloat16")
    a, (images, texts, step) = _one_step(_state(0, tcfg), tcfg)
    ckpt.save_checkpoint(str(tmp_path), "s1", a, {})
    b, _ = ckpt.restore_checkpoint(str(tmp_path), "s1", _state(1, tcfg))
    assert all(st["mu"].dtype == torch.bfloat16 for st in b.optimizer.state.values())
    a, _ = step(a, images, texts, 1)
    b, _ = step(b, images, texts, 1)
    for x, y in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(x, y)


def test_eval_path_reads_the_checkpoint_directory(saved_state, tmp_path):
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    d, state = saved_state
    tiny = configs.tiny_config()
    model = load_eval_model("", "", os.path.join(d, "epoch3"), "fp32", cfg=tiny, device="cpu")
    for (n, a), b in zip(model.module.named_parameters(), state.module.parameters()):
        assert torch.equal(a, b), n
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax .*--save-torch-format"):
        load_eval_model("", "", str(orbax), cfg=tiny, device="cpu")
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_eval_model("", "", str(tmp_path / "ckpts"), cfg=tiny, device="cpu")


# -- the LoRA CLI -------------------------------------------------------------

def _lora_grads_j(params, jcfg, adapters, images, texts, accum, alpha, smooth):
    """The gradient the JAX LoRA step takes (train_lora.py's loss_fn)."""
    def loss_fn(a):
        p = jlora.merge_lora(params, a, alpha)
        opts = JOptions(deterministic=False)
        m = images.shape[0] // accum
        fi = jnp.concatenate([jclip.encode_image(p, jcfg, images[j * m:(j + 1) * m], opts)
                              for j in range(accum)])
        ft = jnp.concatenate([jclip.encode_text(p, jcfg, texts[j * m:(j + 1) * m], opts)
                              for j in range(accum)])
        scale = jnp.exp(params["logit_scale"].astype(jnp.float32))
        return jclip_loss(jclip.normalize(fi), jclip.normalize(ft), scale,
                          label_smoothing=smooth, constrain=False)[0]
    return jax.grad(loss_fn)(adapters)


def test_lora_cli_matches_jax(split, tmp_path, monkeypatch):
    jcfg = _jax_tiny()
    cfg = _port_cfg(jcfg)
    params, _ = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    base = str(tmp_path / "base.pt")
    torch.save({"state_dict": state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)},
               base)
    lr, alpha, smooth, accum = 1e-3, 16.0, 0.05, 2
    argv = lambda out: ["--train-data", split, "--val-data", split, "--tiny-model", "--resume",
                        base, "--precision", "fp32", "--batch-size", "4", "--accum-freq",
                        str(accum), "--epochs", "1", "--lr", str(lr), "--num-threads", "2",
                        "--output-dir", str(tmp_path / out)]
    monkeypatch.setattr(jconfigs, "tiny_config", _jax_tiny)
    monkeypatch.setattr(configs, "tiny_config", lambda: cfg)
    _jax_reader(monkeypatch)
    jsteps, tsteps = [], []
    orig_j, orig_t = jtl.make_lora_step, ttl.make_lora_step

    def recording_j(*a, **kw):
        step, ev = orig_j(*a, **kw)

        def wrapped(p, adapters, opt_state, images, texts, rng):
            out = step(p, adapters, opt_state, images, texts, rng)
            jsteps.append((adapters, np.asarray(images), np.asarray(texts), float(out[2])))
            return out
        return wrapped, ev

    def recording_t(*a, **kw):
        step, ev = orig_t(*a, **kw)

        def wrapped(state, images, texts, generator):
            state, loss, metrics = step(state, images, texts, generator)
            tsteps.append(({k: t.grad.clone() for k, t in _leaves(state.adapters)},
                           float(loss)))
            return state, loss, metrics
        return wrapped, ev

    monkeypatch.setattr(jtl, "make_lora_step", recording_j)
    monkeypatch.setattr(ttl, "make_lora_step", recording_t)
    init_j = jlora.init_lora(jax.random.PRNGKey(SEED), params, rank=4)
    monkeypatch.setattr(ttl, "init_lora", lambda gen, module, rank, text_only, device:
                        lora_from_jax(jax.tree.map(np.asarray, init_j), device))
    want = jtl.main(argv("jax"))
    got = ttl.main(argv("port") + ["--platform", "cpu"])
    assert len(jsteps) == len(tsteps) == 4          # 32 pairs / (4 x 2)
    rows = {}
    for out in ("jax", "port"):
        with open(tmp_path / out / "training_log.csv") as f:
            rows[out] = list(csv.DictReader(f))
    assert list(rows["port"][0]) == list(rows["jax"][0]) == \
        ["epoch", "train_loss", "val_loss", "lr", "is_best"]
    for key in ("epoch", "lr", "is_best"):
        assert rows["port"][0][key] == rows["jax"][0][key], key
    for key in ("train_loss", "val_loss"):
        assert abs(float(rows["port"][0][key]) - float(rows["jax"][0][key])) <= 1.1e-5, key
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    grads_j = jax.jit(lambda a, im, tx: _lora_grads_j(params, jcfg, a, im, tx, accum, alpha,
                                                      smooth))
    slack = {}
    for (adapters, images, texts, loss_j), (grads, loss_t) in zip(jsteps, tsteps):
        assert abs(loss_t - loss_j) <= 1e-5
        taken = flat(grads_j(adapters, images, texts))
        for key, g in grads.items():
            _slack(slack, key, g, torch.from_numpy(np.array(taken[key])), lr)
    want = flat(want)
    for key, t in _leaves(got):
        assert bool(((t.detach() - torch.from_numpy(np.array(want[key]))).abs()
                     <= 1e-6 + slack[key]).all()), key
    template = {k: {m: {n: torch.zeros_like(v) for n, v in d.items()} for m, d in t.items()}
                for k, t in got.items()}
    back, meta = load_lora(str(tmp_path / "port" / "last_lora.npz"), template)
    assert meta == {"epoch": 0, "rank": 4, "alpha": alpha}
    for (k, a), (_, b) in zip(_leaves(back), _leaves(got)):
        assert torch.equal(a.detach(), b.detach()), k


def test_bench_prints_its_json_line(capsys):
    from nans_clip_tpu_torch import bench

    result = bench.main(["--device", "cpu", "--tiny-model", "--batch", "4", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["unit"] == "pairs/sec" and line["value"] > 0
    assert "pct_of_bf16_peak" not in line["detail"]      # no device number from a CPU run
