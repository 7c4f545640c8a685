"""What decides `correct`: the served tokens against the plain reference.

Once the window has closed, two samples drawn from the seed of the
requests the engine finished, one of the greedy and one of the sampled
ones, each with its longest request always in it, go to the reference: it
runs each prompt (the benchmark's own ids) with its served tokens once.
At a greedy token it reads how far the token's logit lies below its best:
a sound program's greedy token is the reference's argmax up to the
program's rounding. At a sampled token it replays the request's sampler
with the request's own coin (reference/<reference>.py: temperature, nucleus,
the coin's place among the prefix sums) and reads how far, in probability
mass, the coin lies from the span the reference gives the served token: a
sound program's coin lies in it up to the rounding of the sums before it.
A token altered, a cache left unwritten, a row of the batch dropped or a
lower precision pushes the gaps up; a wrong temperature, nucleus or
prefix sum moves the coin's place. The numbers compared:

- `max_gap`, `mean_gap`: the widest and the mean gap, in logits, over the
  greedy tokens: a flip to a near tie moves the widest gap little, while
  a lower precision flips many more tokens;
- `max_coin_gap`, `mean_coin_gap`: the widest and the mean gap, in
  probability mass, over the sampled tokens;
- `tokens`, `sampled_tokens`: the greedy and the sampled tokens compared,
  each at least the cell's `min_tokens`;
- `prompt_ids`: sampled requests whose prompt ids, as the program
  encoded them, differ from the benchmark's, at most 0.
"""

from __future__ import annotations

import numpy as np

# each number compared, by the key of its limit in a cell's file, and its rule
NUMBERS = {"max_gap": "<=", "mean_gap": "<=", "max_coin_gap": "<=",
           "mean_coin_gap": "<="}


def sample(records, seed: int, budget: int, greedy: bool) -> list:
    """Finished requests, greedy or sampled: the longest, then others in
    an order drawn from `seed`, until `budget` served tokens."""
    done = [r for r in records if r.spec.greedy == greedy
            and r.req.finished and r.req.out_ids]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.req.out_ids), r.spec.index))
    key = [seed, 0xc4ec] if greedy else [seed, 0xc4ec, 1]
    rest = [done[i] for i in
            np.random.default_rng(key).permutation(len(done) - 1) + 1]
    out, n = [done[0]], len(done[0].req.out_ids)
    for r in rest:
        if n >= budget:
            break
        out.append(r)
        n += len(r.req.out_ids)
    return out


def inputs(picked) -> tuple[list, list, list, list]:
    """(sequences, first predicted position, served tokens, draws) of the
    sample: a sequence is the prompt's bytes and the served tokens but the
    last; a draw is None for a greedy request, else its (temperature,
    top_p, seed)."""
    seqs, first, served, draws = [], [], [], []
    for r in picked:
        ids = list(r.spec.prompt)
        out = list(r.req.out_ids)
        seqs.append(ids + out[:-1])
        first.append(len(ids) - 1)
        served.append(out)
        draws.append(None if r.spec.greedy else
                     (r.spec.temperature, r.spec.top_p, r.spec.seed))
    return seqs, first, served, draws


def readings_of(gaps: list, draws: list) -> dict:
    """The four numbers of one list of picks' gaps (0 with no token)."""
    g = [float(x) for v, d in zip(gaps, draws) if d is None for x in v]
    c = [float(x) for v, d in zip(gaps, draws) if d is not None for x in v]
    return {"max_gap": max(g, default=0.0),
            "mean_gap": sum(g) / len(g) if g else 0.0,
            "max_coin_gap": max(c, default=0.0),
            "mean_coin_gap": sum(c) / len(c) if c else 0.0}


def judge(reference, w: dict, sizes: dict, picked, limits: dict,
          device, extra_picks: dict | None = None) -> tuple[dict, dict]:
    """Compare the sample; returns (checks, readings): checks maps each
    number compared to {"value", "limit", "rule"}; readings maps each
    pick list to its four numbers."""
    seqs, first, served, draws = inputs(picked)
    picks = {"program": served, **(extra_picks or {})}
    readings = {name: readings_of([[] for _ in seqs], draws)
                for name in picks}
    if picked:
        got = reference.gaps(w, sizes, seqs, first, draws, picks, device)
        readings = {name: readings_of(v, draws) for name, v in got.items()}
    checks = {name: {"value": readings["program"][name],
                     "limit": float(limits[name]), "rule": rule}
              for name, rule in NUMBERS.items()}
    for name, greedy in (("tokens", True), ("sampled_tokens", False)):
        checks[name] = {"value": sum(len(s) for s, d in zip(served, draws)
                                     if (d is None) == greedy),
                        "limit": int(limits["min_tokens"]), "rule": ">="}
    checks["prompt_ids"] = {"value": sum(list(r.req.prompt_ids)
                                         != list(r.spec.prompt)
                                         for r in picked),
                            "limit": 0, "rule": "<="}
    return checks, readings


def passed(checks: dict) -> bool:
    for c in checks.values():
        ok = (c["value"] <= c["limit"] if c["rule"] == "<="
              else c["value"] >= c["limit"])
        if not ok:
            return False
    return True
