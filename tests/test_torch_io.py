"""The PyTorch port's numpy-only IO copies against the JAX package's: the
same synthetic artifacts, byte-identical files, the same parsed arrays and
the same BPE token ids."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from qwen3_tpu.config import PRESETS as JPRESETS  # noqa: E402
from qwen3_tpu.io import checkpoint as jck  # noqa: E402
from qwen3_tpu.io import synthetic as jsyn  # noqa: E402
from qwen3_tpu.io import tokenizer_bin as jtb  # noqa: E402
from qwen3_tpu.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from qwen3_tpu_torch.config import PRESETS as TPRESETS  # noqa: E402
from qwen3_tpu_torch.io import checkpoint as tck  # noqa: E402
from qwen3_tpu_torch.io import synthetic as tsyn  # noqa: E402
from qwen3_tpu_torch.io import tokenizer_bin as ttb  # noqa: E402
from qwen3_tpu_torch.tokenizer import Tokenizer as TTokenizer  # noqa: E402


def test_presets_match():
    assert {k: dataclasses.asdict(v) for k, v in TPRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in JPRESETS.items()}


@pytest.mark.parametrize("preset,tied", [("tiny", True), ("tiny8", True),
                                         ("tiny", False)])
def test_checkpoint_bytes_and_arrays_match(tmp_path, preset, tied):
    tcfg = dataclasses.replace(TPRESETS[preset], shared_classifier=tied)
    jcfg = dataclasses.replace(JPRESETS[preset], shared_classifier=tied)
    tw = tsyn.synthetic_weights(tcfg, seed=3)
    jw = jsyn.synthetic_weights(jcfg, seed=3)
    tp, jp = tmp_path / "t.bin", tmp_path / "j.bin"
    tck.write_checkpoint(str(tp), tw)
    jck.write_checkpoint(str(jp), jw)
    assert tp.read_bytes() == jp.read_bytes()
    assert dataclasses.asdict(tck.read_header(str(tp))) == dataclasses.asdict(
        jck.read_header(str(jp)))
    back = tck.load_checkpoint(str(jp))
    for f in dataclasses.fields(jck.Q8Weights):
        if f.name != "config":
            np.testing.assert_array_equal(getattr(back, f.name),
                                          getattr(jw, f.name))


def test_quantize_q8_0_matches():
    w = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    w[0, :4] = [127.0, 0.5, -0.5, 2.5]
    for a, b in zip(tck.quantize_q8_0(w, 32), jck.quantize_q8_0(w, 32)):
        np.testing.assert_array_equal(a, b)


def test_tokenizer_bytes_and_encode_match(tmp_path):
    tt = tsyn.synthetic_tokenizer(512)
    jt = jsyn.synthetic_tokenizer(512)
    assert ttb.dumps_tokenizer_bin(tt) == jtb.dumps_tokenizer_bin(jt)
    path = str(tmp_path / "x.bin.tokenizer")
    jtb.write_tokenizer_bin(path, jt)
    tok = TTokenizer.from_file(path)
    jtok = JTokenizer.from_file(path)
    texts = ["the cat in the hat", "", "<|im_start|>user\nhi<|im_end|>\n",
             "<think>\n\n</think>\n", "ünïcødé and <not a token> there",
             "thethe an and anding <|endoftext|>x"]
    for text in texts:
        assert tok.encode(text) == jtok.encode(text) == jtok.encode_python(
            text)
        ids = tok.encode(text)
        assert tok.decode(ids) == text.encode()
    assert tok.special.as_tuple() == jtok.special.as_tuple()
