"""The yardstick of a language model's step: model FLOPs per token and the
H100's dense peaks by compute dtype.

A model is counted as a list of layers, each a list of parts
(``Attention``, ``Mamba2``, ``Mlp``, ``Moe``, ``CrossAttention``).  A
token's FLOPs in a part are 2 × the weights it is multiplied by,
counting only the experts it is routed to, plus the part's own terms:
the attention score and value products over the positions it sees
(``4 · heads · head_dim`` a position, a sliding-window layer seeing at
most its window), a Mamba-2 state's update and read-out (``4 · heads ·
head_dim · state``), a cross-attention's products over the encoder's
frames.  The head runs once per sequence in a prefill (the last
position's logits) and once per decoded token.  Elementwise work (norms,
activations, the conv's gate, a router's softmax or sigmoid and top-k),
an encoder's work over its frames (``audio``) and a prefix of image
embeddings (``vlm``) are not counted: the count stays at or under what
the program does, so that ``mfu`` cannot pass 100 %.

The layers come from the configuration file where it has a ``layers``
block (``file_plan``: each size the name of a published key of the
file), and otherwise from ``ModelConfig``'s family (``family_plan``).
Nothing here imports the program: its config is data here.
"""

from __future__ import annotations

from dataclasses import dataclass

# Dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# bf16 and fp16 on the tensor cores, float32 outside them (TF32 off).
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 66.9e12}


def _seen(a: int, b: int, window: int | None) -> int:
    """Σ over contexts t = a..b of the positions a token at context t
    attends to: t, or at most ``window``."""
    if b < a:
        return 0
    if window is None or b <= window:
        return (a + b) * (b - a + 1) // 2
    if a > window:
        return window * (b - a + 1)
    return (a + window) * (window - a + 1) // 2 + window * (b - window)


class _Part:
    """A part's FLOPs a token beside its weights (``token_flops``), and
    over the contexts a..b (``span_flops``, what depends on them)."""

    def token_flops(self) -> int:
        return 0

    def span_flops(self, a: int, b: int) -> int:
        return 0


@dataclass(frozen=True)
class Attention(_Part):
    """Self-attention: query, key, value and output projections."""
    heads: int
    kv_heads: int
    head_dim: int
    window: int | None = None

    def weights(self, d: int) -> int:
        return 2 * d * self.heads * self.head_dim \
            + 2 * d * self.kv_heads * self.head_dim

    def span_flops(self, a: int, b: int) -> int:
        return 4 * self.heads * self.head_dim * _seen(a, b, self.window)


@dataclass(frozen=True)
class CrossAttention(_Part):
    """A decoder's attention over an encoder's frames: its query and
    output (the keys and values are the encoder memory's, made once)."""
    heads: int
    head_dim: int
    frames: int

    def weights(self, d: int) -> int:
        return 2 * d * self.heads * self.head_dim

    def token_flops(self) -> int:
        return 4 * self.heads * self.head_dim * self.frames


@dataclass(frozen=True)
class Mamba2(_Part):
    """A Mamba-2 mixer: in_proj to (z, x, B, C, dt), the causal conv over
    (x, B, C), out_proj; the (heads, head_dim, state) state updated and
    read once a token."""
    heads: int
    head_dim: int
    groups: int
    state: int
    conv: int

    def weights(self, d: int) -> int:
        hp, gn = self.heads * self.head_dim, self.groups * self.state
        return d * (2 * hp + 2 * gn + self.heads) \
            + self.conv * (hp + 2 * gn) + hp * d

    def token_flops(self) -> int:
        return 4 * self.heads * self.head_dim * self.state


def _ffn(d: int, width: int, gated: bool) -> int:
    return (3 if gated else 2) * d * width


@dataclass(frozen=True)
class Mlp(_Part):
    """A feed-forward block: gate, up and down (gated) or up and down."""
    width: int
    gated: bool

    def weights(self, d: int) -> int:
        return _ffn(d, self.width, self.gated)


@dataclass(frozen=True)
class Moe(_Part):
    """Routed experts: the router, the ``top_k`` experts a token goes to,
    and a shared expert every token passes (``shared_width`` 0: none)."""
    experts: int
    top_k: int
    width: int
    gated: bool
    shared_width: int = 0

    def weights(self, d: int) -> int:
        return d * self.experts \
            + self.top_k * _ffn(d, self.width, self.gated) \
            + _ffn(d, self.shared_width, self.gated)


@dataclass(frozen=True)
class Plan:
    """What is counted: the model width, the vocabulary of the head, and
    each decoder layer's parts in order."""
    d_model: int
    vocab: int
    layers: tuple[tuple, ...]


# ---- the family's plan (ModelConfig) ----

def _local(c, i: int) -> bool:
    if c.attn_window is None:
        return False
    p = c.local_global_period
    return True if p is None else i % p != p - 1


def _family_layer(c, i: int) -> tuple:
    fam = c.family
    attn = Attention(c.n_heads, c.n_kv_heads, c.head_dim,
                     c.attn_window if _local(c, i) else None)
    ssm = Mamba2(c.ssm_expand * c.d_model // c.ssm_head_dim, c.ssm_head_dim,
                 1, c.ssm_state, c.ssm_conv)
    mlp = Mlp(c.d_ff, gated=True)
    if fam in ("dense", "vlm"):
        return (attn, mlp)
    if fam == "moe":
        return (attn, Moe(c.n_experts, c.top_k, c.d_ff, True,
                          c.dense_residual_ff))
    if fam == "ssm":
        return (ssm,)
    if fam == "hybrid":
        return (attn, ssm, mlp)
    if fam == "audio":
        return (attn, CrossAttention(c.n_heads, c.head_dim, c.n_frames), mlp)
    raise ValueError(f"no FLOP count for the {fam!r} family: its "
                     "configuration file needs a layers block")


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def family_plan(c) -> Plan:
    """The layers of a ``ModelConfig`` (any object with its fields), one
    family's block repeated."""
    return Plan(c.d_model, c.vocab_size,
                tuple(_family_layer(c, i) for i in range(c.n_layers)))


# ---- the file's plan (a ``layers`` block) ----

# each part's fields; a field is the name of a top-level key of the file,
# except ``gated`` (a literal true or false) and a ``window`` of null
PARTS = {"attention": (Attention, ("heads", "kv_heads", "head_dim"),
                       ("window",)),
         "mamba2": (Mamba2, ("heads", "head_dim", "groups", "state", "conv"),
                    ()),
         "mlp": (Mlp, ("width", "gated"), ()),
         "moe": (Moe, ("experts", "top_k", "width", "gated"),
                 ("shared_width",))}
BLOCK_KEYS = {"pattern", "hidden", "vocab", "kinds"}


def _size(cfg: dict, key, where: str, what: str, none_ok=False):
    if not isinstance(key, str):
        raise ValueError(f"{where}: layers: {what} must name a top-level "
                         f"key of the file, not {key!r}")
    if key not in cfg:
        raise ValueError(f"{where}: layers: {what} names {key!r}, which "
                         "is no top-level key of the file")
    v = cfg[key]
    if v is None and none_ok:
        return None
    if isinstance(v, bool) or not isinstance(v, int) or v < 1:
        raise ValueError(f"{where}: layers: {what} names {key!r}, which "
                         f"holds {v!r}, not a whole number >= 1")
    return v


def _part(cfg: dict, spec: dict, where: str, what: str):
    name = spec.get("part") if isinstance(spec, dict) else None
    if name not in PARTS:
        raise ValueError(f"{where}: layers: {what} is no part of "
                         f"{sorted(PARTS)}: {spec!r}")
    cls, required, optional = PARTS[name]
    fields = set(spec) - {"part"}
    if not set(required) <= fields <= set(required) | set(optional):
        raise ValueError(f"{where}: layers: {what} ({name}) needs "
                         f"{list(required)}, may take {list(optional)}; "
                         f"has {sorted(fields)}")
    kw = {}
    for f in sorted(fields):
        if f == "gated":
            if not isinstance(spec[f], bool):
                raise ValueError(f"{where}: layers: {what}.gated must be "
                                 "true or false")
            kw[f] = spec[f]
        elif f == "window" and spec[f] is None:
            kw[f] = None
        else:
            kw[f] = _size(cfg, spec[f], where, f"{what}.{f}",
                          none_ok=f == "window")
    return cls(**kw)


def file_plan(cfg: dict, where: str = "config") -> Plan:
    """The layers a configuration file's ``layers`` block states: the
    pattern (a top-level published key, as run) letter by letter, each
    letter's parts with their sizes read from the file's keys.  Checks
    that every named key is there, that every letter has a kind, and that
    the pattern is a contiguous slice of ``source_settings``' pattern,
    ``num_hidden_layers`` long; a ValueError names ``where``."""
    block = cfg.get("layers")
    if not isinstance(block, dict) or set(block) != BLOCK_KEYS:
        raise ValueError(f"{where}: layers must hold exactly "
                         f"{sorted(BLOCK_KEYS)}")
    key = block["pattern"]
    pattern = cfg.get(key) if isinstance(key, str) else None
    if not isinstance(pattern, str) or not pattern:
        raise ValueError(f"{where}: layers: pattern must name a top-level "
                         f"key that holds the layer pattern, not {key!r}")
    published = cfg.get("source_settings", {}).get(key)
    if not isinstance(published, str) or pattern not in published:
        raise ValueError(f"{where}: layers: {key} {pattern!r} is no "
                         f"contiguous slice of source_settings' {key}")
    if len(pattern) != cfg.get("num_hidden_layers"):
        raise ValueError(f"{where}: layers: {key} has {len(pattern)} "
                         "layers, num_hidden_layers "
                         f"{cfg.get('num_hidden_layers')!r}")
    kinds = block["kinds"]
    if not isinstance(kinds, dict):
        raise ValueError(f"{where}: layers: kinds must map letters to parts")
    missing = sorted(set(pattern) - set(kinds))
    if missing:
        raise ValueError(f"{where}: layers: the pattern's letters "
                         f"{missing} have no kind")
    built = {}
    for letter, parts in kinds.items():
        if not isinstance(parts, list) or not parts:
            raise ValueError(f"{where}: layers: kind {letter!r} must be a "
                             "list of one part or more")
        built[letter] = tuple(_part(cfg, p, where, f"kinds[{letter!r}][{i}]")
                              for i, p in enumerate(parts))
    return Plan(_size(cfg, block["hidden"], where, "hidden"),
                _size(cfg, block["vocab"], where, "vocab"),
                tuple(built[ch] for ch in pattern))


def plan(c, config: dict | None = None) -> Plan:
    """The file's plan where ``config`` has a ``layers`` block, else the
    family's of ``c``."""
    if config is not None and "layers" in config:
        return file_plan(config)
    return family_plan(c)


# ---- the counts ----

def _span_flops(p: Plan, a: int, b: int) -> int:
    """Model FLOPs of the tokens at contexts a..b, without the head."""
    n = b - a + 1
    total = 0
    for layer in p.layers:
        for part in layer:
            total += n * (2 * part.weights(p.d_model) + part.token_flops()) \
                + part.span_flops(a, b)
    return total


def head_flops(p: Plan) -> int:
    return 2 * p.d_model * p.vocab


def prefill_flops(c, prompt: int, config: dict | None = None) -> int:
    """One sequence's prefill of ``prompt`` tokens (logits of the last)."""
    p = plan(c, config)
    return _span_flops(p, 1, prompt) + head_flops(p)


def decode_flops(c, prompt: int, gen: int, config: dict | None = None) -> int:
    """One sequence's ``gen`` decode steps after a prompt of ``prompt``:
    step j feeds the token at context prompt + j."""
    p = plan(c, config)
    return _span_flops(p, prompt + 1, prompt + gen) + gen * head_flops(p)


def peak_flops(c) -> float:
    """The card's dense peak in the configuration's compute dtype."""
    if c.dtype not in PEAK_FLOPS:
        raise ValueError(f"no peak for compute dtype {c.dtype!r}")
    return PEAK_FLOPS[c.dtype]
