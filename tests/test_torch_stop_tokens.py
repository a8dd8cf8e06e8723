"""EOS stop tokens (``SamplingParams.stop_token_ids``) in the port: the
cases of ``tests/test_stop_tokens.py``, and a stop run through both
packages.

Contract under test (DESIGN.md §6 finish semantics):
  * real mode: a decoded token matching the stop set ends the turn with
    ``finish_reason="stop"`` (vs ``"length"`` at the max_tokens budget);
    the stop token itself STAYS in the streamed delta and the token
    history — truncation is presentation, the bit-exact history is the
    engine's parity anchor, so the pre-stop stream must be a prefix of
    the unconstrained greedy stream;
  * the first decoded token can itself be the stop token (the
    prefill-emission path, not the batch-decode path, must check);
  * a stop hit exactly at the max_tokens boundary reports ``"stop"``,
    not ``"length"`` (the more informative reason wins);
  * sim mode carries no token ids: stop sets are accepted but can
    never fire — a sim request always runs to its length budget.
"""
import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import SamplingParams as JaxSamplingParams
from repro.core import ServingEngine as JaxServingEngine
from repro.data import priority as jax_priority
from repro_torch.core import EngineConfig, SamplingParams, ServingEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import synth_prompt_ids
from torch_parity import (assert_histories_agree, assert_sim_equal,
                          smoke_bundles)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def engine_model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


def _real_cfg():
    return EngineConfig(mode="real", num_gpu_blocks=32, num_cpu_blocks=128,
                        max_running=4, max_batch=4).with_policy("fastswitch")


def _drain(eng, max_iters=20_000):
    outs = []
    it = 0
    while eng.has_work() and it < max_iters:
        outs.extend(eng.step())
        it += 1
    assert not eng.has_work()
    return outs


def _run_real(model, prompt_ids, max_tokens, stop=()):
    eng = ServingEngine(_real_cfg(), model_bundle=model, stream_tokens=True)
    eng.add_request(prompt_ids,
                    SamplingParams(max_tokens=max_tokens,
                                   stop_token_ids=tuple(stop)))
    outs = _drain(eng)
    toks = [t for o in outs if o.token_ids for t in o.token_ids]
    fin = [o for o in outs if o.finished]
    assert len(fin) == 1
    return toks, fin[0]


def test_sim_stop_ids_accepted_but_never_fire():
    eng = ServingEngine(
        EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                     max_running=4).with_policy("fastswitch"),
        trace=PriorityTrace("random", 1e-9, seed=0))
    eng.add_request(24, SamplingParams(max_tokens=10, stop_token_ids=(3, 5)))
    outs = _drain(eng)
    fin = [o for o in outs if o.finished]
    assert len(fin) == 1
    assert fin[0].finish_reason == "length"
    assert fin[0].generated == 10


def test_real_stop_mid_stream_prefix_exact(engine_model):
    vocab = engine_model["cfg"].vocab_size
    prompt = synth_prompt_ids(11, 0, 16, vocab)
    hist, fin = _run_real(engine_model, prompt, 12)
    assert fin.finish_reason == "length" and len(hist) == 12

    stop_tok = hist[7]
    cut = hist.index(stop_tok)           # earliest hit wins
    toks, fin2 = _run_real(engine_model, prompt, 12, stop=(stop_tok,))
    assert fin2.finish_reason == "stop"
    # the stop token stays in the stream; everything before it is the
    # unconstrained greedy prefix, bit-exact
    assert toks == hist[:cut + 1]
    assert fin2.generated == cut + 1


def test_real_stop_on_first_token(engine_model):
    vocab = engine_model["cfg"].vocab_size
    prompt = synth_prompt_ids(12, 0, 16, vocab)
    hist, _ = _run_real(engine_model, prompt, 8)
    toks, fin = _run_real(engine_model, prompt, 8, stop=(hist[0],))
    assert fin.finish_reason == "stop"
    assert toks == hist[:1]
    assert fin.generated == 1


def test_real_stop_at_length_boundary_upgrades_reason(engine_model):
    vocab = engine_model["cfg"].vocab_size
    prompt = synth_prompt_ids(13, 0, 16, vocab)
    hist, _ = _run_real(engine_model, prompt, 10)
    stop_tok = hist[-1]
    cut = hist.index(stop_tok)
    toks, fin = _run_real(engine_model, prompt, 10, stop=(stop_tok,))
    # even when the stop lands on the final budgeted token, the reason
    # reports the stop (the earliest occurrence in the stream decides)
    assert fin.finish_reason == "stop"
    assert toks == hist[:cut + 1]


def test_real_stop_with_retained_session_parks(engine_model):
    """A stop-finished turn with ``retain_kv`` parks like a length
    finish — follow-ups continue from the truncated history."""
    vocab = engine_model["cfg"].vocab_size
    prompt = synth_prompt_ids(14, 0, 16, vocab)
    hist, _ = _run_real(engine_model, prompt, 8)
    stop_tok = hist[3]
    cut = hist.index(stop_tok)

    eng = ServingEngine(_real_cfg(), model_bundle=engine_model,
                        stream_tokens=True)
    h = eng.add_request(prompt, SamplingParams(max_tokens=8,
                                               stop_token_ids=(stop_tok,)),
                        retain_kv=True)
    outs = _drain(eng)
    fin = [o for o in outs if o.finished]
    assert fin[0].finish_reason == "stop"
    assert h in eng.parked
    assert eng.parked[h].token_history == list(prompt) + hist[:cut + 1]
    eng.continue_session(h, synth_prompt_ids(14, 1, 8, vocab),
                         SamplingParams(max_tokens=4))
    outs2 = _drain(eng)
    fin2 = [o for o in outs2 if o.finished]
    assert fin2[0].finish_reason == "length"


# ---------------------------------------------------------------------------
# both packages, the same scenarios
# ---------------------------------------------------------------------------


def _stop_run(engine_cls, cfg_cls, sp_cls, trace, model, stop_at=7):
    """Three requests in one batch, the first with a stop token taken from
    its own stop-free run (index ``stop_at``); returns the engine."""
    vocab = model["cfg"].vocab_size if model else None
    eng = engine_cls(cfg_cls(mode="real" if model else "sim",
                             num_gpu_blocks=32, num_cpu_blocks=128,
                             max_running=4, max_batch=4
                             ).with_policy("fastswitch"),
                     trace=trace, model_bundle=model, stream_tokens=True)
    prompts = [synth_prompt_ids(11 + i, 0, 16, vocab) if model else 16
               for i in range(3)]
    stop = ()
    if model is not None:
        free = engine_cls(eng.config, trace=trace, model_bundle=model,
                          stream_tokens=True)
        free.add_request(prompts[0], sp_cls(max_tokens=12))
        hist = [t for o in _drain(free) if o.token_ids for t in o.token_ids]
        free.shutdown()
        stop = (hist[stop_at],)
    for i, p in enumerate(prompts):
        eng.add_request(p, sp_cls(max_tokens=12,
                                  stop_token_ids=stop if i == 0 else (3,)))
    outs = _drain(eng)
    eng.finishes = [(o.handle, o.finish_reason, o.generated)
                    for o in outs if o.finished]
    if eng.runner is not None:
        eng.runner.flush()
    eng.shutdown()
    return eng


def test_sim_stop_matches_reference():
    """Stop sets in sim mode through both packages: they never fire, and
    the runs are equal."""
    ours = _stop_run(ServingEngine, EngineConfig, SamplingParams,
                     PriorityTrace("random", 1e-9, seed=0), None)
    ref = _stop_run(JaxServingEngine, JaxEngineConfig, JaxSamplingParams,
                    jax_priority.PriorityTrace("random", 1e-9, seed=0), None)
    assert ours.finishes == ref.finishes
    assert {r for _, r, _ in ours.finishes} == {"length"}
    assert_sim_equal(ours, ref)


def test_real_stop_matches_reference():
    """A stop token mid-stream beside two stop-free requests, through both
    packages: the same finish reasons and counts, event log, and greedy
    histories equal or first different at a near-tie."""
    jb, tb = smoke_bundles()
    ours = _stop_run(ServingEngine, EngineConfig, SamplingParams,
                     PriorityTrace("random", 1e-9, seed=0), tb)
    ref = _stop_run(JaxServingEngine, JaxEngineConfig, JaxSamplingParams,
                    jax_priority.PriorityTrace("random", 1e-9, seed=0), jb)
    assert ("stop" in {r for _, r, _ in ours.finishes})
    assert ours.finishes == ref.finishes
    assert [e.as_dict() for e in ours.events] == \
        [e.as_dict() for e in ref.events]
    assert_histories_agree(tb, ours._token_hist_by_conv,
                           ref._token_hist_by_conv)
