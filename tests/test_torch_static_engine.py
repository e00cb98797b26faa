"""The port's static inference engine against the JAX package's, fp32 on
the CPU, from the same weights (models/convert.py:params_from_jax).

- Greedy streams token-exact on a llama-style (GQA, swiglu, rmsnorm,
  rope, untied) and a gpt2-style (learned positions, layernorm, biases,
  tied) config, a batch of two prompts.
- The per-token callback: the same steps and tokens, and the masked
  logits within 1e-4 of their max.
- Beam search: the same best beam; its score (the sum of the continuation's
  log-probabilities under teacher forcing, float64 sums of fp32 terms)
  within 1e-4 of JAX's.
- eod stops early as JAX's loop stops; generate_text through the
  NullTokenizer gives JAX's texts.
- The max_seq_len error has JAX's message; an MLA config is refused.
- Sampled streams repeat for a seed (torch's draws are not jax.random's:
  the law is the same, the bits are not).
"""

import numpy as np
import pytest
import torch

from megatronapp_tpu.inference import engine as je
from megatronapp_tpu_torch.inference import engine as te
from test_torch_engine import _weights

ARCHS = ("llama", "gpt2")
MAX_SEQ = 24
NEW = 8


def _prompts(seed=0, b=2, s=5):
    return np.random.default_rng(seed).integers(0, 127, (b, s)).astype(
        np.int32)


def _engines(arch, max_seq=MAX_SEQ, tokenizer=False):
    jc, tc, jp, tp = _weights(arch)
    tok_j = tok_t = None
    if tokenizer:
        from megatronapp_tpu.data.tokenizers import NullTokenizer as JNull
        from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
        tok_j, tok_t = JNull(128), NullTokenizer(128)
    return (je.StaticInferenceEngine(jp, jc, tokenizer=tok_j,
                                     max_seq_len=max_seq),
            te.StaticInferenceEngine(tp, tc, tokenizer=tok_t,
                                     max_seq_len=max_seq, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_token_exact_with_jax(arch):
    j, t = _engines(arch)
    prompts = _prompts(1)
    want = j.generate(prompts, NEW, je.SamplingParams(greedy=True))
    got = t.generate(prompts, NEW, te.SamplingParams(greedy=True))
    assert got.shape == (2, 5 + NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_callback_sequence_matches_jax(arch):
    j, t = _engines(arch)
    prompts = _prompts(2)
    seen = {"j": [], "t": []}
    j.generate(prompts, 5, je.SamplingParams(greedy=True),
               token_callback=lambda *a: seen["j"].append(a))
    t.generate(prompts, 5, te.SamplingParams(greedy=True),
               token_callback=lambda *a: seen["t"].append(a))
    assert len(seen["t"]) == len(seen["j"]) == 5
    for (sj, tj, lj), (st, tt, lt) in zip(seen["j"], seen["t"]):
        assert st == sj and tt.dtype == np.int32
        np.testing.assert_array_equal(tt, np.asarray(tj))
        assert lt.shape == np.asarray(lj).shape
        np.testing.assert_allclose(lt, lj, rtol=0,
                                   atol=1e-4 * np.abs(lj).max())


def _score(prompt, beam, logits):
    """Sum of the continuation's log-probabilities under teacher forcing
    (float64 sums of fp32 log-softmax terms, as beam_search adds them),
    from the [S, V] logits of one forward over the whole beam."""
    logp = np.asarray(logits, np.float32)
    logp = logp - logp.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    s = prompt.shape[1]
    return sum(float(logp[i - 1, beam[i]]) for i in range(s, len(beam)))


@pytest.mark.parametrize("arch", ARCHS)
def test_beam_search_matches_jax(arch):
    """The same best beam; its score under the port's forward within 1e-4
    of its score under JAX's."""
    j, t = _engines(arch)
    prompt = _prompts(3, b=1)
    want = np.asarray(je.beam_search(j, prompt, 6, beam_width=4))
    got = te.beam_search(t, prompt, 6, beam_width=4)
    np.testing.assert_array_equal(got, want)
    beam = want[0]
    logits_j, _ = je._forward_with_cache(
        j.params, beam[None].astype(np.int32),
        je.init_kv_cache(j.cfg, 1, j.max_seq_len), 0, j.cfg)
    logits_t, _ = t._forward(torch.as_tensor(beam[None], dtype=torch.long),
                             te.init_kv_cache(t.cfg, 1, t.max_seq_len,
                                              "cpu"), 0)
    ref = _score(prompt, beam, logits_j[0])
    assert abs(_score(prompt, got[0], logits_t[0].numpy()) - ref) <= (
        1e-4 * max(1, abs(ref)))


def test_eod_stops_early_like_jax():
    j, t = _engines("llama")
    prompts = _prompts(1)
    stream = j.generate(prompts, NEW, je.SamplingParams(greedy=True))
    eod = int(stream[0, 5 + 2])      # the first row's third new token
    want = j.generate(prompts[:1], NEW, je.SamplingParams(greedy=True),
                      eod_id=eod)
    got = t.generate(prompts[:1], NEW, te.SamplingParams(greedy=True),
                     eod_id=eod)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape[1] < 5 + NEW


def test_generate_text_matches_jax():
    j, t = _engines("gpt2", tokenizer=True)
    prompts = ["1 2 3", "40 50 60 70"]
    sp = dict(greedy=True)
    assert (t.generate_text(prompts, 6, te.SamplingParams(**sp))
            == j.generate_text(prompts, 6, je.SamplingParams(**sp)))


def test_max_seq_len_error_is_jax_message():
    j, t = _engines("llama", max_seq=8)
    prompts = _prompts(0)
    with pytest.raises(ValueError) as jerr:
        j.generate(prompts, 4)
    with pytest.raises(ValueError) as terr:
        t.generate(prompts, 4)
    assert str(terr.value) == str(jerr.value)


def test_mla_static_engine_is_refused():
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    cfg = llama3_8b(num_layers=1, hidden_size=64, num_attention_heads=4,
                    num_query_groups=4, ffn_hidden_size=128, vocab_size=128,
                    multi_latent_attention=True, kv_lora_rank=32,
                    qk_head_dim=16, qk_pos_emb_head_dim=8, v_head_dim=16)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="dense slot cache"):
        te.StaticInferenceEngine(params, cfg, device="cpu")


def test_sampled_streams_repeat_for_a_seed():
    _, t = _engines("llama")
    prompts = _prompts(4)
    sp = te.SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=7)
    a = t.generate(prompts, NEW, sp)
    assert np.array_equal(a, t.generate(prompts, NEW, sp))
    other = t.generate(prompts, NEW, te.SamplingParams(
        temperature=0.9, top_k=20, top_p=0.9, seed=8))
    assert not np.array_equal(a, other)
    assert a.min() >= 0 and a.max() < 128


def test_sample_logits_filters_as_jax():
    """top-k and top-p keep exactly the tokens JAX's filter keeps: every
    draw lands in that set."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 64)).astype(np.float32)
    sp = te.SamplingParams(temperature=0.7, top_k=5, top_p=0.5)
    gen = torch.Generator().manual_seed(0)
    x = logits / 0.7
    kth = np.sort(x, axis=-1)[:, -5][:, None]
    x = np.where(x < kth, -1e30, x)
    srt = np.sort(x, axis=-1)[:, ::-1]
    p = np.exp(srt - srt.max(-1, keepdims=True))
    cum = np.cumsum(p / p.sum(-1, keepdims=True), axis=-1)
    cut = np.take_along_axis(srt, (cum < 0.5).sum(-1)[:, None], axis=-1)
    keep = x >= cut
    for _ in range(50):
        toks = te.sample_logits(torch.from_numpy(logits), gen, sp).numpy()
        assert keep[np.arange(4), toks].all()
    greedy = te.sample_logits(torch.from_numpy(logits), gen,
                              te.SamplingParams(greedy=True))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_serve_builds_the_static_engine():
    """--engine static (the default) builds the static engine with the
    NullTokenizer and its dense cache of --max-seq-len positions."""
    from megatronapp_tpu_torch import serve
    args = serve.parse_args(["--preset", "gpt2-125m", "--num-layers", "1",
                             "--device", "cpu", "--max-seq-len", "16"])
    eng = serve.build_engine(args)
    assert isinstance(eng, te.StaticInferenceEngine)
    assert eng.max_seq_len == 16 and eng.cfg.num_layers == 1
    out = eng.generate_text(["1 2 3"], 3, te.SamplingParams(greedy=True))
    assert len(out[0].split()) == 3


@pytest.mark.parametrize("argv,msg", [
    (["--megakernel-decode"], "--megakernel-decode requires --engine "
                              "dynamic"),
    (["--kv-cache-dtype", "int8"], "--kv-cache-dtype requires"),
    (["--spec-method", "ngram"], "--spec-method requires"),
    (["--serve-tp", "2"], "--serve-tp requires"),
])
def test_serve_static_refuses_dynamic_only_flags(argv, msg, capsys):
    from megatronapp_tpu_torch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err
