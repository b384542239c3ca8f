"""The language-model driver: the port's LM serving path, one batch at a
time as ``repro_torch.launch.serve`` serves one.

A configuration (``configs/<name>.json``) names ``driver: "lm_serve"``,
an ``arch`` of ``repro_torch.configs.registry`` and the ``overrides`` of
``ModelConfig`` fields that its cut replaces (depth, experts held, a
vocabulary slice).  Beside them: its ``source`` and ``source_settings``
(the published config's keys and numbers), those keys at the top level
as they are run, ``assumed``, ``deployment``, the compute ``dtype``, a
plain ``reference`` module (a path under the benchmark's root) and the
``guarantees`` (``logit_err``).  A workload (``workloads/<cell>.json``)
gives ``config``, ``loop: "closed"``, ``batch`` (sequences served
together), ``lengths`` (``[prompt_len, gen]`` pairs: batch k takes pair
k mod S), ``check_sequences`` and ``check_steps``.

Set-up builds the model (``build_model``), fills every parameter from
the seed (``draw_``: the benchmark's weights, never the program's own
initializer), and serves one batch of every pair.  The window is a
closed loop of batches: ``make_prefill_step(model, prompt + gen)``, then
``gen`` greedy ``make_decode_step`` calls, the host reading each token
as ``serve.run`` does; it adds no scheduling, padding or EOS handling.
It runs until ``seconds`` have passed and at least one batch of every
pair has run: the sample, ``check_sequences`` sequences drawn from the
seed among those first S batches, is the same whatever the speed.  Of
them it keeps the prefill's logits and ``check_steps`` decode steps'
spread over ``gen``, the last among them.  A sequence's latency runs from
its batch's start to its last token (after a sync); a sequence fails
where its prefill's or its last step's logits, or a kept row, hold NaN
or ∞.

After the window the program's state is freed, the weights are drawn
again from the seed, and the configuration's reference runs in float32
(TF32 off), one sequence at a time, over each sampled prompt and the
tokens the timed path emitted (teacher forcing).  ``logit_err`` is the
largest of max |got − want| / rms(want) over the kept rows.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from detbench import harness, tracer
from detbench.traffic import seed_entropy

# the published config's keys → the ``ModelConfig`` fields that hold them;
# where the configuration file has one, the program must run its value
HF_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
    "hidden_act": "act",
}
# families served by prefill and decode alone (vlm needs image
# embeddings, audio an encoder's frames: neither is made here)
FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the precision below each compute dtype: the control's
CONTROL_DTYPE = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn",
                 "float16": "float8_e4m3fn"}
# spawn keys of the seed's streams
_WEIGHT_KEY, _WARM_KEY, _BATCH_KEY, _SAMPLE_KEY = 1, 2, 3, 4
# a vector's entries (norm offsets, the SSM's constants, biases)
VECTOR_STD = 0.1


@dataclass(frozen=True)
class LMWorkload:
    name: str
    config: str
    loop: str
    batch: int
    lengths: tuple[tuple[int, int], ...]
    check_sequences: int
    check_steps: int


def workload_from_dict(name: str, d: dict) -> LMWorkload:
    """Validate an LM workload file's contents."""
    if d.get("loop", "closed") != "closed":
        raise ValueError(f"{name}: lm_serve runs a closed loop only")
    batch = int(d["batch"])
    lengths = tuple((int(p), int(g)) for p, g in d["lengths"])
    if batch < 1 or not lengths:
        raise ValueError(f"{name}: needs batch >= 1 and one pair or more")
    if any(p < 1 or g < 1 for p, g in lengths):
        raise ValueError(f"{name}: lengths must be [prompt >= 1, gen >= 1]")
    if len(set(lengths)) != len(lengths):
        raise ValueError(f"{name}: a pair is listed twice")
    seqs, steps = int(d["check_sequences"]), int(d["check_steps"])
    if not 1 <= seqs <= batch * len(lengths):
        raise ValueError(f"{name}: check_sequences must lie in 1..batch x "
                         "pairs (the first batch of every pair)")
    if not 0 <= steps <= min(g for _, g in lengths):
        raise ValueError(f"{name}: check_steps must lie in 0..the "
                         "shortest gen")
    return LMWorkload(name=name, config=str(d["config"]), loop="closed",
                      batch=batch, lengths=lengths, check_sequences=seqs,
                      check_steps=steps)


def load_workload(name: str, root: Path) -> LMWorkload:
    return workload_from_dict(
        name, json.loads((root / "workloads" / f"{name}.json").read_text()))


def model_config(cfg: dict, where: str = "config"):
    """The ``ModelConfig`` a configuration file states: its arch's with
    the overrides, checked against the file's published keys."""
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.models.config import ModelConfig
    if cfg.get("driver") != "lm_serve":
        raise ValueError(f"{where}: driver is not lm_serve")
    if cfg.get("arch") not in ARCHS:
        raise ValueError(f"{where}: arch {cfg.get('arch')!r} is not in the "
                         "port's registry")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(cfg["overrides"]) - fields
    if unknown:
        raise ValueError(f"{where}: overrides name no ModelConfig field: "
                         f"{sorted(unknown)}")
    mcfg = get_config(cfg["arch"]).replace(**cfg["overrides"])
    if mcfg.family not in FAMILIES:
        raise ValueError(f"{where}: the {mcfg.family} family is not served "
                         f"by lm_serve (only {FAMILIES})")
    if mcfg.dtype != cfg["dtype"]:
        raise ValueError(f"{where}: states dtype {cfg['dtype']}, the program "
                         f"would compute in {mcfg.dtype}")
    differ = {k: (cfg[k], getattr(mcfg, f)) for k, f in HF_FIELDS.items()
              if k in cfg and cfg[k] != getattr(mcfg, f)}
    if differ:
        raise ValueError(f"{where}: the program would run other values "
                         f"(file, program): {differ}")
    return mcfg


def load_config(name: str, root: Path) -> tuple[dict, object]:
    """(the configuration file's dict, its ``ModelConfig``), validated."""
    path = root / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    ref = Path(cfg["reference"])
    if ref.is_absolute() or ".." in ref.parts or ref.suffix != ".py" \
            or not (root / ref).is_file():
        raise ValueError(f"{path}: reference {cfg['reference']!r} is no "
                         "module under the benchmark's root")
    if float(cfg["guarantees"]["logit_err"]) <= 0:
        raise ValueError(f"{path}: needs a logit_err limit > 0")
    return cfg, model_config(cfg, str(path))


def stream_seed(seed: int, *keys: int) -> int:
    """A torch generator's seed for the stream ``keys`` of ``seed`` (any
    whole number)."""
    ss = np.random.SeedSequence(seed_entropy(seed), spawn_key=keys)
    return int(ss.generate_state(1, np.uint64)[0])


def _name_key(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                          "little")


def draw_(t, name: str, seed: int):
    """Fill the parameter ``name`` in place from the seed, in its own
    dtype on its own device: a matrix or a stack of them N(0, fan_in⁻¹)
    with fan_in = ``shape[-2]`` (``x @ w`` takes ``(in, out)``), a vector
    N(0, 0.1²).  Each parameter has a stream of its own by its name, so
    the order of the parameters does not change what is drawn."""
    import torch
    g = torch.Generator(device=t.device)
    g.manual_seed(stream_seed(seed, _WEIGHT_KEY, _name_key(name)))
    std = t.shape[-2] ** -0.5 if t.ndim >= 2 else VECTOR_STD
    return t.normal_(0.0, std, generator=g)


def batch_tokens(seed: int, key: int, b: int, batch: int, prompt: int,
                 vocab: int, device):
    """Batch b's prompts, (batch, prompt) ids drawn from the seed."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, key, b))
    return torch.randint(0, vocab, (batch, prompt), generator=g,
                         device=device)


def keep_steps(gen: int, n: int) -> list[int]:
    """``n`` decode steps spread over 1..gen, the last among them."""
    return sorted({gen * (i + 1) // n for i in range(n)})


def sample_rows(w: LMWorkload, seed: int) -> list[list[int]]:
    """The rows drawn for the comparison in the first batch of each pair:
    ``check_sequences`` in all, spread over the pairs."""
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        seed_entropy(seed), spawn_key=(_SAMPLE_KEY,))))
    S, n = len(w.lengths), w.check_sequences
    return [sorted(rng.choice(w.batch, n // S + (s < n % S),
                              replace=False).tolist()) for s in range(S)]


@dataclass
class Sampled:
    """One sampled sequence: its batch and row, its prompt, the tokens
    the timed path emitted, and its kept logits rows by step (0: the
    prefill's)."""
    batch: int
    row: int
    prompt: object
    emitted: np.ndarray
    kept: dict


@dataclass
class Sample:
    """What the check needs once the program's state is freed: the
    parameters' names, shapes and dtypes (to draw them again) and the
    sampled sequences."""
    layout: list
    sequences: list[Sampled] = field(default_factory=list)


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def serve_batch(prefill, decode, tokens, gen: int, rows, steps, tr):
    """One batch as ``serve.run`` serves it (greedy, no EOS) → (emitted
    tokens (B, gen), kept logits rows by step, the sequences whose
    prefill or last logits are not all finite, a device bool (B,))."""
    import torch
    with tr.span("lm.prefill"):
        logits, cache = prefill({"tokens": tokens})
    first_ok = torch.isfinite(logits).all(-1)
    kept = {0: logits[rows]} if rows is not None else {}
    tok = torch.argmax(logits, dim=-1)[:, None].int()
    out = []
    for step in range(1, gen + 1):
        out.append(tok[:, 0].cpu().numpy())
        with tr.span("lm.decode"):
            logits, cache = decode(cache, {"tokens": tok})
        if rows is not None and step in steps:
            kept[step] = logits[rows]
        tok = torch.argmax(logits, dim=-1)[:, None].int()
    bad = ~(first_ok & torch.isfinite(logits).all(-1))
    return np.stack(out, axis=1), kept, bad


def serve_window(w: LMWorkload, cfg: dict, mcfg, seed: int, seconds: float,
                 trace: bool, *, device: str = "cuda",
                 t_start: float | None = None):
    """Set-up and the measured window → (the run's context, the
    sample)."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    if t_start is None:
        t_start = time.perf_counter()
    run = harness.Run(workload=w, config=cfg, model=mcfg, device=device)
    if device == "cuda":
        torch.cuda.init()
    S, B, V = len(w.lengths), w.batch, mcfg.vocab_size
    rows = sample_rows(w, seed)
    steps = [set(keep_steps(g, w.check_steps)) if w.check_steps else set()
             for _, g in w.lengths]
    off = tracer.Trace(False, device)
    with torch.inference_mode():
        model = build_model(mcfg, device=device)
        layout = []
        for name, p in model.named_parameters():
            draw_(p, name, seed)
            layout.append((name, tuple(p.shape), p.dtype))
        sample = Sample(layout=layout)
        prefills = [make_prefill_step(model, p + g) for p, g in w.lengths]
        decode = make_decode_step(model)
        for s, (p, g) in enumerate(w.lengths):
            serve_batch(prefills[s], decode,
                        batch_tokens(seed, _WARM_KEY, s, B, p, V, device),
                        g, None, (), off)
        _sync(device)
        run.setup_s = time.perf_counter() - t_start
        harness.log(f"set-up {run.setup_s:.3f} s ({S} warm-up batches of "
                    f"{B})")
        t_batch, pairs, bad = [], [], []
        with harness._Collections() as coll, \
                tracer.Trace(trace, device) as tr:
            t_open = time.perf_counter()
            t_end = t_open + seconds
            b = 0
            while b < S or time.perf_counter() < t_end:
                s = b % S
                p, g = w.lengths[s]
                idx = (torch.tensor(rows[s], device=device) if b < S
                       else None)
                tokens = batch_tokens(seed, _BATCH_KEY, b, B, p, V, device)
                t0 = time.perf_counter()
                with tr.span("client.batch"):
                    emitted, kept, failed = serve_batch(
                        prefills[s], decode, tokens, g, idx, steps[s], tr)
                    _sync(device)
                t_batch.append((t0, time.perf_counter()))
                pairs.append(s)
                bad.append(failed)
                if idx is not None:
                    sample.sequences += [
                        Sampled(batch=b, row=r, prompt=tokens[r],
                                emitted=emitted[r].copy(),
                                kept={k: v[i] for k, v in kept.items()})
                        for i, r in enumerate(rows[s])]
                b += 1
            t_close = time.perf_counter()
        run.collections = coll.counts
        if device == "cuda":
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        bad = torch.stack(bad).cpu().numpy()
        for q in sample.sequences:
            if not all(bool(torch.isfinite(v).all()) for v in q.kept.values()):
                bad[q.batch, q.row] = True
    t_batch = np.asarray(t_batch)
    lengths = np.asarray(w.lengths, dtype=np.int64)[pairs]
    run.window_s = t_close - t_open
    run.drain_s = max(0.0, t_close - t_end)
    run.attempted = run.answered = B * len(pairs)
    run.failed = int(bad.sum())
    run.shapes = np.repeat(lengths, B, axis=0)
    run.grads = np.zeros(run.attempted, bool)
    run.latency_s = np.repeat(t_batch[:, 1] - t_batch[:, 0], B)
    run.tokens_prefill = int(B * lengths[:, 0].sum())
    run.tokens_decode = int(B * lengths[:, 1].sum())
    harness.log(f"window {run.window_s:.3f} s: {len(pairs)} batches, "
                f"{run.answered} sequences, {run.tokens_prefill} prefill and "
                f"{run.tokens_decode} decode tokens, {run.failed} failed; "
                f"drain {run.drain_s:.3f} s")
    c = run.collections
    harness.log("python collections in the window: "
                + ", ".join(f"gen{i} {c['count'][i]}" for i in range(3))
                + f"; gen2 {c['gen2_s']:.3f} s in all")
    if trace and tr.events is not None:
        run.traced = tracer.reduce(tr.events, {}, {})
        t = run.traced
        if device == "cuda":
            harness.log(f"card: {harness.card_line()} (mfu against the "
                        "H100's dense peak at 700 W)")
        harness.log(f"trace: {t['device_events']} device and "
                    f"{t['host_events']} host events; busy "
                    f"{t['busy_s']:.6f} s")
    return run, sample


def reference_module(cfg: dict, root: Path):
    """The configuration's plain reference, loaded by path."""
    path = root / cfg["reference"]
    spec = importlib.util.spec_from_file_location(
        f"detbench_reference_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rounded(t, dtype_name: str):
    """``t`` in float32 after a round trip through ``dtype_name``; float8
    with one scale per tensor (its largest entry to the format's
    largest), as a float8 serving path stores weights."""
    import torch
    dt = getattr(torch, dtype_name)
    x = t.float()
    if dt.is_floating_point and torch.finfo(dt).bits == 8:
        scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dt).max
        return (x / scale).to(dt).float() * scale
    return x.to(dt).float()


def compare(sample: Sample, cfg: dict, seed: int, device: str, root: Path,
            control: str | None = None) -> dict[str, float]:
    """The worst ``logit_err`` of the sampled sequences against the
    reference in float32 over the weights drawn again.  With ``control``
    (a dtype's name) the rows compared are instead the reference's own
    with every matrix rounded through that dtype."""
    import torch
    ref = reference_module(cfg, root)
    with torch.inference_mode():
        params = {}
        for name, shape, dtype in sample.layout:
            params[name] = draw_(torch.empty(shape, dtype=dtype,
                                             device=device), name, seed)
        lowered = ({k: rounded(v, control) if v.ndim >= 2 else v
                    for k, v in params.items()} if control else None)
        worst = 0.0
        for q in sample.sequences:
            toks = torch.cat([q.prompt.to(device).long(), torch.as_tensor(
                q.emitted, device=device).long()])[None]
            at = [len(q.prompt) - 1 + k for k in sorted(q.kept)]
            want = ref.forward(params, cfg, toks)[0, at]
            got = (ref.forward(lowered, cfg, toks)[0, at] if control
                   else torch.stack([q.kept[k] for k in sorted(q.kept)]
                                    ).to(device).float())
            rms = want.square().mean(-1).sqrt()
            err = ((got - want).abs().amax(-1) / rms).max().item()
            # NaN (a row that is no number) is worse than any number
            worst = max(worst, err if err == err else math.inf)
    return {"logit_err": worst, "compared": len(sample.sequences)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             bench: dict, device: str = "cuda", t_start: float | None = None,
             root: Path = harness.HERE) -> dict:
    """One run → the result line's object (``checks`` last)."""
    import torch
    w = load_workload(cell, root)
    cfg, mcfg = load_config(w.config, root)
    run, sample = serve_window(w, cfg, mcfg, seed, seconds, trace,
                               device=device, t_start=t_start)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = compare(sample, cfg, seed, device, root)
    harness.log(f"reference: {worst.pop('compared')} sequences compared in "
                f"{time.perf_counter() - t0:.3f} s")
    return harness.result_line(run, worst, cfg["guarantees"], cell=cell,
                               trace=trace, bench=bench, device=device,
                               root=root)


def control_readings(cell: str, seed: int, *, device: str,
                     root: Path = harness.HERE) -> dict:
    """The program's and the control's ``logit_err`` on one seed, over
    the sample of the window's first batch of every pair."""
    import torch
    w = load_workload(cell, root)
    cfg, mcfg = load_config(w.config, root)
    t0 = time.perf_counter()
    _, sample = serve_window(w, cfg, mcfg, seed, 0.0, False, device=device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    program = compare(sample, cfg, seed, device, root)
    dtype = CONTROL_DTYPE[mcfg.dtype]
    control = compare(sample, cfg, seed, device, root, control=dtype)
    limit = float(cfg["guarantees"]["logit_err"])
    return {"workload": cell, "seed": seed, "dtype": dtype,
            "compared": control.pop("compared"),
            "seconds": time.perf_counter() - t0,
            "checks": {"logit_err": {
                "program": program["logit_err"],
                "value": control["logit_err"], "limit": limit,
                "fails": not control["logit_err"] <= limit}}}
