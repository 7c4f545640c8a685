"""The traffic, the weights and the prompts come from the seed alone."""

import collections
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

import tiny
from cudabench.core import tokfile
from cudabench.core.traffic import RequestStream, quantiles

BENCH = Path(__file__).resolve().parents[1]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def specs(m, seed, n):
    s = RequestStream(m, seed)
    return [s[i] for i in range(n)]


def test_same_seed_same_requests_other_seed_others():
    for name in ("reason", "chat"):
        m = mix(name)
        a, b = specs(m, 2**31 + 7, 200), specs(m, 2**31 + 7, 200)
        c = specs(m, 2**31 + 8, 200)
        assert [(x.prompt, x.max_tokens, x.seed, x.greedy) for x in a] == \
            [(x.prompt, x.max_tokens, x.seed, x.greedy) for x in b]
        assert [x.prompt for x in a] != [x.prompt for x in c]
        assert [x.seed for x in a] != [x.seed for x in c]


def test_every_seed_sends_the_same_sizes_in_another_order():
    m = mix("chat")
    k = m["block"]
    for seed in (1, 2, 3_000_000_011):
        got = specs(m, seed, 3 * k)
        for blk in range(1, 3):       # past the first wave
            part = got[blk * k:(blk + 1) * k]
            assert sorted(len(x.prompt) for x in part) == \
                sorted(quantiles(m["prompt_tokens"], k).tolist())
            assert sorted(x.max_tokens for x in part) == \
                sorted(quantiles(m["output_tokens"], k).tolist())
            assert sum(x.greedy for x in part) == round(
                m["greedy_share"] * k)
    a = [len(x.prompt) for x in specs(m, 1, 2 * k)]
    b = [len(x.prompt) for x in specs(m, 2, 2 * k)]
    assert a != b and sorted(a) == sorted(b)


def test_first_wave_caps_are_shares_of_full_caps():
    m = mix("reason")
    k = m["clients"]
    first = specs(m, 5, k)
    assert all(1 <= x.max_tokens <= m["output_tokens"]["high"]
               for x in first)
    assert min(x.max_tokens for x in first) < m["output_tokens"]["low"]
    later = specs(m, 5, 2 * k)[k:]
    assert all(m["output_tokens"]["low"] <= x.max_tokens
               <= m["output_tokens"]["high"] for x in later)


def test_quantiles_hand_worked():
    assert quantiles({"dist": "uniform", "low": 0, "high": 10}, 5).tolist() \
        == [1, 3, 5, 7, 9]
    q = quantiles({"dist": "loguniform", "low": 64, "high": 1024}, 2)
    assert q.tolist() == [round(64 * 16 ** 0.25), round(64 * 16 ** 0.75)]


def test_prompts_are_their_own_ids(tmp_path):
    from qwen3_tpu_torch.tokenizer import Tokenizer

    path = tmp_path / "bytes.tokenizer"
    tokfile.write(path, 151936)
    tok = Tokenizer.from_file(str(path), use_native=False)
    assert tok.vocab_size == 151936
    for x in specs(mix("chat"), 9, 80):
        assert b"<" not in x.prompt
        assert tok.encode(x.prompt) == list(x.prompt)
    assert tok.decode([65, 66]) == b"AB"
    assert tok.special.eos == 257 and tok.special.bos == 256


def test_same_seed_same_weights_other_seed_others():
    model = tiny.model()
    s = model.sizes_of({
        "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
        "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
        "rope_theta": 1e6, "quantization": {"group_size": 32}})
    spec = {"scale": 0.02}
    cpu = torch.device("cpu")
    a = model.make(s, 2**31 + 3, spec, cpu)
    b = model.make(s, 2**31 + 3, spec, cpu)
    c = model.make(s, 2**31 + 4, spec, cpu)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq_q"], c["wq_q"])
    assert a["w2_q"].shape == (2, 64, 128) and a["w2_s"].shape == (2, 64, 4)
    assert a["wq_q"].dtype == torch.int8
    assert int(a["wq_q"].min()) >= -127
    counts = collections.Counter(np.sign(a["w1_q"].numpy().ravel()))
    assert counts[1] > 0 and counts[-1] > 0


def checksum(w: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(w):
        h.update(k.encode())
        h.update(w[k].contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_the_tiny_tensors_keep_their_bytes():
    """The dense block's tensors at one seed, byte for byte as the harness
    made them before the model module held their families and order."""
    model = tiny.model()
    w = model.make(model.sizes_of(tiny.CONFIG), 2**31 + 12345,
                   tiny.CONFIG["weights"], torch.device("cpu"))
    assert checksum(w) == ("e84be4b51c4d37201125c9bba3a6969d"
                           "6f156526fc6ce228cfb161e9d1ce2b28")
