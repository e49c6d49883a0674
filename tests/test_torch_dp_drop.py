"""Data parallelism with the draws that one process makes for the global
batch: text dropout (``ops/dropout.py``'s sample offset), FLIP tokens and
augmentation (``data/augment.py::preprocess_images(rows=...)``) at data 2
against the port's one-rank step, on the CPU in fp32.

One pair of gloo processes (``tests/test_torch_dp_worker.py``) runs
``tiny_config()`` and ViT-B-16@RoBERTa-base cut to 2 layers a tower (images
at 32 px), each with text dropout 0.1, ``mask_ratio`` 0.5 and augmentation
of raw 40-pixel images, accum 2, two steps, every rank on its rows of the
global batch (``distributed.rank_rows``); this process runs the same steps
on one rank at the global batch. The draws are equal, so only the order of
sums differs: the losses within 1e-5, each gradient within 1e-4 of its
largest magnitude (BERT's key biases, 0 in exact arithmetic, below 1e-8 on
both sides), the ranks' parameters bit-equal; the ranks' augmented images,
FLIP tokens and dropout masks concatenated equal one rank's exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.parallel import distributed, mesh
from tests import test_torch_dp_worker as worker

torch.set_num_threads(2)

TCFG = dict(lr=1e-3, warmup=1, max_steps=10)


def _texts(b, seed):
    rs = np.random.RandomState(seed)
    texts = np.zeros((b, 52), np.int32)
    texts[:, 0] = 101
    texts[:, 1:12] = rs.randint(1000, 20000, (b, 11))
    texts[:, 12] = 102
    texts[0, 6:12] = 0
    return texts


def _dropout_cases() -> dict:
    """Text dropout 0.1, FLIP 0.5 and augmentation: ``tiny_config()`` and
    ViT-B-16@RoBERTa-base cut to 2 layers a tower (images at 32 px), raw
    uint8 images of 40 px, accum 2, two steps."""
    base = tconfigs.with_resolution(
        tconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 32)
    base = dataclasses.replace(base, vision=dataclasses.replace(base.vision, layers=2),
                               text=dataclasses.replace(base.text, num_hidden_layers=2))
    cases = {}
    for name, cfg, b in (("tiny", tconfigs.tiny_config(), 16), ("roberta-base", base, 8)):
        assert cfg.text.hidden_dropout_prob == cfg.text.attention_probs_dropout_prob == 0.1
        texts = _texts(b, seed=3)
        raw = np.random.RandomState(4).randint(0, 256, (b, 40, 40, 3)).astype(np.uint8)
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(1))
        cases[name] = dict(cfg=cfg, state_dict={k: v.numpy() for k, v in
                                                module.state_dict().items()},
                           images=raw, texts=texts, aug_seed=9, seeds=[5, 6],
                           tcfg=dict(TCFG, accum_freq=2, mask_ratio=0.5))
    return cases


@pytest.fixture(scope="module")
def drop_run(tmp_path_factory):
    """The data-2 ranks, then the one-rank references here."""
    payload = {"dropout": _dropout_cases()}
    ranks = mesh.run_ranks(worker.run_data2, 2, "gloo",
                           str(tmp_path_factory.mktemp("rendezvous") / "init"), (payload,),
                           timeout_s=300.0)
    opts = ModelOptions(attn_impl="fused", deterministic=False)
    one = {name: worker.one_rank(c, opts) for name, c in payload["dropout"].items()}
    return ranks, one, payload


def _check_grads(got: dict, want: dict, rel: float = 1e-4):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        if name.endswith("self.key.bias"):
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= 1e-8, name
        else:
            assert float(np.abs(g - w).max()) <= rel * float(np.abs(w).max()), name


@pytest.mark.parametrize("case", ["tiny", "roberta-base"])
def test_dp_with_dropout_flip_augment_matches_one_rank(drop_run, case):
    """Text dropout, FLIP 0.5 and augmentation at data 2 against the port's
    one-rank step on the same global batch and seeds, accum 2, two steps:
    the losses, every gradient, the parameters bit-equal on both ranks; the
    ranks' augmented images and FLIP tokens are one rank's rows exactly."""
    ranks, one, payload = drop_run
    ref, c = one[case], payload["dropout"][case]
    n = c["images"].shape[0]
    for d, r in enumerate(ranks):
        got = r["dropout"][case]
        assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) <= 1e-5
        _check_grads(got["grads"], ref["grads"])
        idx = distributed.rank_row_index(d, 2, 2, n // 4).numpy()
        np.testing.assert_array_equal(got["images"], ref["images"][idx])
    for name, p in ranks[0]["dropout"][case]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["dropout"][case]["params"][name], err_msg=name)
    np.testing.assert_array_equal(np.concatenate([r["flip"][case] for r in ranks]),
                                  worker.flip_rows(c, 0, 1))


def test_dropout_masks_count_samples_from_sample0():
    """The attention and hidden masks of a rank holding samples ``sample0``
    on of a microbatch are one process's rows of the whole microbatch's;
    the kernels take the offset (``kernel_args``), a head offset still
    runs the twins."""
    micro, heads, seq, width, seed = 3, 4, 12, 64, 77
    parts = []
    for d in range(2):
        attn = drop.Dropout(seed, 0.1, drop.STREAM_ATTN, sample0=d * micro)
        hid = drop.Dropout(seed, 0.1, drop.STREAM_HIDDEN, seq, sample0=d * micro)
        parts.append((drop.attention_multiplier(attn, micro, heads, seq, "cpu"),
                      drop.hidden_multiplier(hid, micro * seq, width, "cpu")))
        assert attn.kernel_args()[-1] == d * micro
    whole_a = drop.attention_multiplier(drop.Dropout(seed, 0.1, drop.STREAM_ATTN), 2 * micro,
                                        heads, seq, "cpu")
    whole_h = drop.hidden_multiplier(drop.Dropout(seed, 0.1, drop.STREAM_HIDDEN, seq),
                                     2 * micro * seq, width, "cpu")
    assert torch.equal(torch.cat([a for a, _ in parts]), whole_a)
    assert torch.equal(torch.cat([h for _, h in parts]), whole_h)
    assert 0.8 < float((whole_a > 0).float().mean()) < 0.97
    seeded = drop.sub_block(drop.Seed(seed, 6), 0.1, 0.1, seq)
    assert all(s.sample0 == 6 and s.seed == seed for s in seeded)
    assert drop.sub_block(seed, 0.1, 0.0, seq)[0] == drop.Dropout(seed, 0.1, drop.STREAM_ATTN)
    with pytest.raises(ValueError, match="head offset"):
        drop.Dropout(seed, 0.1, drop.STREAM_ATTN, head0=2).kernel_args()


def test_text_tower_rows_draw_the_whole_batch_masks():
    """The text tower's training forward on rows ``sample0`` on of a batch,
    from the same generator seed, is the whole batch's forward on those
    rows: the embedding dropout and every layer's masks count the global
    sample."""
    cfg = tconfigs.tiny_config()
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(2))
    ids = torch.from_numpy(_texts(6, seed=8)).long()
    opts = ModelOptions(attn_impl="fused", deterministic=False)
    mask = (ids != 0).float()
    with torch.no_grad():
        whole = module.bert(ids, mask, opts, torch.Generator().manual_seed(4))
        rows = [module.bert(ids[s:s + 3], mask[s:s + 3], opts, torch.Generator().manual_seed(4),
                            sample0=s) for s in (0, 3)]
        plain = module.bert(ids, mask, dataclasses.replace(opts, deterministic=True))
    torch.testing.assert_close(torch.cat(rows), whole, rtol=1e-6, atol=1e-6)
    assert float((whole - plain).abs().max()) > 0.1
