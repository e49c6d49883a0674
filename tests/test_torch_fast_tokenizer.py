"""The port's native WordPiece tokenizer (``data/fast_tokenizer.py`` over
``csrc/tokenizer.cpp``) against the port's Python tokenizer and the JAX
package's native and Python tokenizers: ids exactly equal on the golden set,
the framing cases and a seeded fuzz set; its build lands in the git-ignored
``build/`` directory, and a build that fails raises with the compiler's
message."""

import json
import random
from pathlib import Path

import numpy as np
import pytest

from nans_clip_tpu.data.fast_tokenizer import get_fast_tokenizer as jget_fast
from nans_clip_tpu.tokenizer import tokenize as jtokenize
from nans_clip_tpu_torch.data import fast_tokenizer
from nans_clip_tpu_torch.data.fast_tokenizer import FastTokenizer, get_fast_tokenizer
from nans_clip_tpu_torch.tokenizer import get_tokenizer, tokenize

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_tokenizer.json").read_text(encoding="utf-8"))
FRAMING = ["西湖美景", "", "Hello 世界", "宋" * 100, "ΚΑΛΟΣ。国", "ΟΔΥΣΣΕΥΣ ΚΑΙ ΣΙΣΥΦΟΣ",
           "Σ3", "HELLO, Wörld!  Ｆｕｌｌwidth ｔｅｘｔ 123", "咖啡☕和tea，混合café au lait…",
           "中文标点：《书名》、“引号”—破折号", "x" * 250]


def _fuzz(alphabet, n=300, seed=7):
    rng = random.Random(seed)
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60))) for _ in range(n)]


# tests/test_fast_tokenizer.py's alphabet, and one with the line and
# paragraph separators (U+2028, U+2029), tabs and newlines
FUZZ = "南宋古籍绘画佛经abcXYZ019, .!?？。¥$#@[]（）café é 　驪"
SEPARATORS = FUZZ + "ΣΑ\u2028\u2029\t\n"


def test_builds_into_the_build_dir():
    ft = get_fast_tokenizer()
    path = fast_tokenizer.lib_path()
    assert path.is_file() and path.parent == ROOT / "nans_clip_tpu_torch" / "build"
    assert not list((ROOT / "nans_clip_tpu_torch" / "csrc").glob("*.so"))
    assert not list((ROOT / "nans_clip_tpu_torch" / "csrc").glob("*.inc"))
    assert ft is get_fast_tokenizer()


@pytest.mark.parametrize("case", ["golden", "framing", "fuzz"])
def test_ids_equal_python_and_jax(case):
    ft, pt, jft = get_fast_tokenizer(), get_tokenizer(), jget_fast()
    assert jft is not None
    texts = {"golden": [g["text"] for g in GOLDEN], "framing": FRAMING,
             "fuzz": _fuzz(FUZZ)}[case]
    for t in texts:
        assert ft.encode(t) == pt.encode(t) == jft.encode(t), repr(t)
    if case == "golden":
        for g in GOLDEN:
            assert ft.encode(g["text"]) == g["ids"], g["text"]
    for length in (52, 12, 2):
        ours = ft.encode_batch(texts, length)
        assert ours.dtype == np.int32 and ours.shape == (len(texts), length)
        np.testing.assert_array_equal(ours, tokenize(texts, length))
        np.testing.assert_array_equal(ours, jft.encode_batch(texts, length))
        np.testing.assert_array_equal(ours, jtokenize(texts, length))


def test_line_separators_split_as_python():
    """U+2028 / U+2029 split words in the Python tokenizers (``str.split``);
    the JAX package's native tokenizer keeps them inside a word (so "a\u2028b"
    is one [UNK] there), the port's splits as Python does."""
    ft, pt, jft = get_fast_tokenizer(), get_tokenizer(), jget_fast()
    texts = _fuzz(SEPARATORS)
    for t in texts:
        assert ft.encode(t) == pt.encode(t), repr(t)
    np.testing.assert_array_equal(ft.encode_batch(texts, 52), jtokenize(texts, 52))
    for t in ("a\u2028b", "西湖\u2029美景", "é\u2028X"):
        assert ft.encode(t) == pt.encode(t) != jft.encode(t), repr(t)


def test_loader_tokenizes_natively(tmp_path):
    from nans_clip_tpu_torch.data.dataset import DataLoader, PairDataset
    from nans_clip_tpu_torch.drill import make_dataset

    make_dataset(str(tmp_path), 32, 2, 1)
    ds = PairDataset(str(tmp_path / "train"))
    native = DataLoader(ds, batch_size=4, decode_size=32, shuffle=False, num_threads=2)
    python = DataLoader(ds, batch_size=4, decode_size=32, shuffle=False, num_threads=2,
                        tokenizer=get_tokenizer())
    assert isinstance(native._fast_tok, FastTokenizer) and python._fast_tok is None
    for a, b in zip(native, python):
        np.testing.assert_array_equal(a.texts, b.texts)
        assert a.texts.dtype == np.int32


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tokenizer.cpp").write_text("this is not C++;\n")
    (csrc / "gen_unicode_tables.py").write_bytes(
        (ROOT / "nans_clip_tpu_torch" / "csrc" / "gen_unicode_tables.py").read_bytes())
    monkeypatch.setattr(fast_tokenizer, "CSRC", csrc)
    monkeypatch.setattr(fast_tokenizer, "SOURCES", (csrc / "tokenizer.cpp",
                                                    csrc / "gen_unicode_tables.py"))
    monkeypatch.setattr(fast_tokenizer, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)native tokenizer failed.*error"):
        fast_tokenizer.build()
    assert not list((tmp_path / "build").glob("*.so"))
