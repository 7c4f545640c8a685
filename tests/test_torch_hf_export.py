"""The port's HF exporter (io/hf_export.py) against the JAX package's:
on a tiny random Qwen3 HF checkpoint and byte-level BPE tokenizer, built
as tests/test_hf_export.py's hf_dir fixture builds them, the `.bin` and
`.tokenizer` the two write are byte-identical, through the functions and
through the console entry point. Skipped without transformers."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from qwen3_tpu.io import hf_export as jax_export  # noqa: E402
from qwen3_tpu_torch.io import hf_export  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import load_checkpoint  # noqa: E402
from qwen3_tpu_torch.tokenizer import Tokenizer  # noqa: E402


def _hf_model(d: Path, tied: bool) -> str:
    """Tiny random Qwen3 HF checkpoint + byte-level BPE tokenizer (the
    hf_dir fixture of tests/test_hf_export.py, untied as well)."""
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers import models
    from transformers import Qwen3Config, Qwen3ForCausalLM

    cfg = Qwen3Config(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=128, tie_word_embeddings=tied,
        rms_norm_eps=1e-6)
    torch.manual_seed(0)
    Qwen3ForCausalLM(cfg).save_pretrained(d)
    b2u = hf_export.bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for a, b in [("t", "h"), ("th", "e"), ("i", "n"), ("a", "n"),
                 ("an", "d"), ("e", "r"), ("h", "e"), ("Ġ", "t"),
                 ("Ġt", "he")]:
        vocab[a + b] = len(vocab)
        merges.append((a, b))
    tok = HFTokenizer(models.BPE(vocab=vocab, merges=merges))
    for sp in ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
               "<think>", "</think>", "<tool_call>", "</tool_call>",
               "<tool_response>", "</tool_response>"]:
        tok.add_special_tokens([sp])
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "PreTrainedTokenizerFast"}))
    return str(d)


@pytest.mark.parametrize("tied", [True, False])
def test_export_bytes_match_jax(tmp_path, tied):
    hf_dir = _hf_model(tmp_path / "hf", tied)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export.export_tokenizer(hf_dir, want)
    jax_export.export_model(hf_dir, want + ".bin", group_size=32)
    hf_export.export_tokenizer(hf_dir, got)
    cfg = hf_export.export_model(hf_dir, got + ".bin", group_size=32)
    assert cfg.shared_classifier is tied
    for suffix in (".bin", ".tokenizer"):
        assert Path(got + suffix).read_bytes() == \
            Path(want + suffix).read_bytes(), suffix
    w = load_checkpoint(got + ".bin")
    assert w.config.dim == 128 and w.config.n_layers == 2
    t = Tokenizer.from_file(got)
    ids = t.encode("the cat and the hat <|im_end|>")
    assert t.decode(ids) == b"the cat and the hat <|im_end|>"
    assert ids[-1] == t.special.eos


def test_export_main_matches_jax(tmp_path):
    """`qwen3-tpu-torch-export output_file input_dir -g G` writes what
    `qwen3-tpu-export` writes (the JAX entry point names the tokenizer
    `<output_file>.tokenizer` and the weights `<output_file>`)."""
    hf_dir = _hf_model(tmp_path / "hf", True)
    want, got = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    assert jax_export.main([want, hf_dir, "-g", "64"]) == 0
    assert hf_export.main([got, hf_dir, "-g", "64"]) == 0
    for suffix in ("", ".tokenizer"):
        assert Path(got + suffix).read_bytes() == \
            Path(want + suffix).read_bytes(), suffix
