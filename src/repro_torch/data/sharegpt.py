"""Synthetic ShareGPT-like multi-turn conversation traces.

The paper (§4, Fig. 4) uses Multi-Round ShareGPT: ~5.5 turns/conversation
on average, 78 % multi-turn, log-normal-ish prompt/response lengths, and
Poisson arrivals at 1 req/s.  We generate statistically matched synthetic
conversations (the dataset itself is not redistributable offline).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Turn:
    prompt_tokens: int
    response_tokens: int
    # actual prompt token ids (real mode, supplied by the serving client
    # at add_request/continue_session time); None for sim-mode traces
    prompt_ids: Optional[List[int]] = None


@dataclass
class Conversation:
    conv_id: int
    arrival_s: float            # first-turn arrival time
    turns: List[Turn]
    think_time_s: float = 5.0   # user gap between turns


def sample_conversations(n: int, *, rate_req_s: float = 1.0, seed: int = 0,
                         mean_turns: float = 5.5,
                         multi_turn_frac: float = 0.78,
                         prompt_mu: float = 4.6, prompt_sigma: float = 0.9,
                         resp_mu: float = 5.1, resp_sigma: float = 0.7,
                         max_tokens: int = 3500,
                         max_context: int = 6000) -> List[Conversation]:
    """Poisson arrivals; geometric-ish turn counts conditioned on the
    multi-turn fraction; log-normal prompt/response token lengths.
    ``max_context`` bounds the cumulative conversation context (a
    conversation must fit the serving pool, as in any deployed system)."""
    rng = random.Random(seed)
    out: List[Conversation] = []
    t = 0.0
    for i in range(n):
        t += rng.expovariate(rate_req_s)
        if rng.random() < multi_turn_frac:
            # shifted geometric with mean ~ (mean_turns - adj)
            p = 1.0 / (mean_turns - (1 - multi_turn_frac)) if mean_turns > 1 else 1.0
            k = 2 + _geometric(rng, p)
        else:
            k = 1
        turns = []
        ctx = 0
        for _ in range(k):
            pt = int(min(max_tokens, max(4, rng.lognormvariate(prompt_mu, prompt_sigma))))
            rt = int(min(max_tokens, max(4, rng.lognormvariate(resp_mu, resp_sigma))))
            if turns and ctx + pt + rt > max_context:
                break
            pt = min(pt, max(4, max_context - ctx - 8))
            rt = min(rt, max(4, max_context - ctx - pt))
            ctx += pt + rt
            turns.append(Turn(prompt_tokens=pt, response_tokens=rt))
        out.append(Conversation(conv_id=i, arrival_s=t, turns=turns,
                                think_time_s=max(0.5, rng.gauss(5.0, 2.0))))
    return out


def synth_prompt_ids(conv_id: int, turn_idx: int, n_tokens: int,
                     vocab_size: int) -> List[int]:
    """Deterministic synthetic prompt ids for one (conversation, turn) —
    the token stream real-mode replay clients submit via ``add_request``
    (a pure function of the ids, so any driver regenerates the identical
    prompt: the bit-exact-replay anchor)."""
    import numpy as np
    rng = np.random.RandomState((conv_id * 1009 + turn_idx) % (2 ** 31))
    return rng.randint(1, vocab_size, size=n_tokens).tolist()


def prompt_for_turn(conv: "Conversation", turn_idx: int,
                    vocab_size: Optional[int] = None):
    """What a replay client passes as ``add_request``'s prompt for one
    trace turn: the synthetic id stream when serving a real model
    (``vocab_size`` given), else just the sim-mode token count."""
    turn = conv.turns[turn_idx]
    if vocab_size is None:
        return turn.prompt_tokens
    return synth_prompt_ids(conv.conv_id, turn_idx, turn.prompt_tokens,
                            vocab_size)


def _geometric(rng: random.Random, p: float) -> int:
    """Number of failures before first success."""
    u = rng.random()
    return int(math.floor(math.log(max(u, 1e-12)) / math.log(max(1 - p, 1e-12))))


def trace_stats(convs: List[Conversation]) -> dict:
    turns = [len(c.turns) for c in convs]
    toks = [t.prompt_tokens + t.response_tokens for c in convs for t in c.turns]
    return {
        "n": len(convs),
        "mean_turns": sum(turns) / len(turns),
        "multi_turn_frac": sum(1 for k in turns if k > 1) / len(turns),
        "mean_turn_tokens": sum(toks) / len(toks),
    }
