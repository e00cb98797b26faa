"""Transformer architecture configuration.

Counterpart of the JAX package's ``config/transformer_config.py``: the
same field names and enums, with ``params_dtype``/``compute_dtype`` as
torch dtypes. Fields that select JAX/TPU machinery (remat, scan unroll,
flash block sizes, cp/tp overlap, fp8) are kept so a config reads the
same on both sides; the serving slice does not consult them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class AttnMaskType(enum.Enum):
    causal = "causal"
    padding = "padding"
    bidirectional = "bidirectional"


class ActivationKind(enum.Enum):
    gelu = "gelu"
    swiglu = "swiglu"
    geglu = "geglu"
    relu = "relu"
    squared_relu = "squared_relu"


class NormKind(enum.Enum):
    layernorm = "LayerNorm"
    rmsnorm = "RMSNorm"


class PositionEmbeddingKind(enum.Enum):
    rope = "rope"
    learned_absolute = "learned_absolute"
    yarn = "yarn"
    none = "none"


@dataclasses.dataclass
class TransformerConfig:
    """Architecture hyperparameters (field semantics as in the JAX
    package's TransformerConfig)."""

    num_layers: int = 2
    hidden_size: int = 128
    num_attention_heads: int = 8
    # GQA: number of KV heads (reference: num_query_groups).
    num_query_groups: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    kv_channels: Optional[int] = None
    vocab_size: int = 50304
    # Tokenizer's true vocab when vocab_size is padded: inference masks
    # logits for padded ids so sampling cannot emit out-of-vocab tokens.
    true_vocab_size: Optional[int] = None
    max_position_embeddings: int = 2048

    normalization: NormKind = NormKind.layernorm
    layernorm_epsilon: float = 1e-5
    activation: ActivationKind = ActivationKind.gelu
    position_embedding: PositionEmbeddingKind = PositionEmbeddingKind.rope
    rotary_base: float = 10000.0
    rotary_percent: float = 1.0
    rope_scaling_factor: float = 1.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_coeff: float = 0.1
    add_qkv_bias: bool = False
    add_bias_linear: bool = True
    qk_layernorm: bool = False
    attn_mask_type: AttnMaskType = AttnMaskType.causal
    untie_embeddings_and_output_weights: bool = False

    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0

    init_method_std: float = 0.02

    attention_softmax_in_fp32: bool = True
    apply_query_key_layer_scaling: bool = False

    # MoE / MTP: later slices (the serving slice raises on them). MLA
    # (multi_latent_attention) serves on the paged engine.
    num_moe_experts: Optional[int] = None
    moe_router_topk: int = 2
    moe_ffn_hidden_size: Optional[int] = None
    moe_aux_loss_coeff: float = 0.0
    moe_z_loss_coeff: float = 0.0
    moe_shared_expert_intermediate_size: Optional[int] = None
    moe_capacity_factor: Optional[float] = None
    moe_layer_freq: int = 1
    mtp_num_layers: Optional[int] = None
    mtp_loss_scaling_factor: float = 0.1
    multi_latent_attention: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_head_dim: int = 128
    qk_pos_emb_head_dim: int = 64
    v_head_dim: int = 128

    # dtype policy: params kept in fp32, compute in bf16 by default.
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    # JAX-side machinery knobs, kept for field parity.
    remat_policy: str = "selective"
    cp_comm_type: str = "p2p"
    hierarchical_cp_a2a_size: int = 2
    cp_zigzag: bool = True
    cp_comm_overlap: bool = True
    moe_comm_overlap: bool = True
    attention_impl: str = "auto"
    tp_comm_overlap: bool = False
    tp_sharded_stage: bool = True
    flash_min_seq: int = 2048
    flash_block_q: int = 512
    flash_block_kv: int = 512
    scan_unroll: int = 1
    flash_head_fold: bool = False
    fp8: bool = False
    fp8_margin: int = 0
    fp8_amax_history_len: int = 16
    heterogeneous_layers_config_json: Optional[str] = None

    def __post_init__(self):
        if self.heterogeneous_layers_config_json:
            raise NotImplementedError(
                "heterogeneous per-layer configs are not ported yet (the "
                "other-families slice)")
        if self.ffn_hidden_size is None:
            if self.activation in (ActivationKind.swiglu,
                                   ActivationKind.geglu):
                self.ffn_hidden_size = int(4 * self.hidden_size * 2 / 3)
            else:
                self.ffn_hidden_size = 4 * self.hidden_size
        if self.kv_channels is None:
            self.kv_channels = self.hidden_size // self.num_attention_heads
        if self.num_query_groups is None:
            self.num_query_groups = self.num_attention_heads
        if self.num_attention_heads % self.num_query_groups != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_query_groups ({self.num_query_groups})")
        if self.num_moe_experts is not None \
                and self.moe_ffn_hidden_size is None:
            self.moe_ffn_hidden_size = self.ffn_hidden_size

    @property
    def is_moe(self) -> bool:
        return self.num_moe_experts is not None

    @property
    def head_dim(self) -> int:
        return self.kv_channels

    def attention_parameters(self) -> int:
        """Parameters of one layer's attention projections: GQA's q, kv
        and out kernels, or MLA's q path (q_proj, or q_down, its norm and
        q_up), kv_down, the latent norm, kv_up and the out kernel."""
        h, nq = self.hidden_size, self.num_attention_heads
        if not self.multi_latent_attention:
            d = self.head_dim
            return h * nq * d + 2 * h * self.num_query_groups * d \
                + nq * d * h
        dqk, dpe = self.qk_head_dim, self.qk_pos_emb_head_dim
        klat, dv = self.kv_lora_rank, self.v_head_dim
        q_out = nq * (dqk + dpe)
        q = (h * self.q_lora_rank + self.q_lora_rank
             + self.q_lora_rank * q_out) if self.q_lora_rank else h * q_out
        return (q + h * (klat + dpe) + klat + klat * nq * (dqk + dv)
                + nq * dv * h)

    def num_parameters(self) -> int:
        """Approximate parameter count (embedding + blocks + final norm).
        Unlike the JAX package's, it counts MLA's projections as they
        are (``attention_parameters``)."""
        h = self.hidden_size
        v = self.vocab_size
        per_layer = self.attention_parameters() + 2 * h
        if self.activation in (ActivationKind.swiglu, ActivationKind.geglu):
            per_layer += 3 * h * self.ffn_hidden_size
        else:
            per_layer += 2 * h * self.ffn_hidden_size
        per_layer += 2 * h
        total = v * h + per_layer * self.num_layers + 2 * h
        if self.position_embedding == PositionEmbeddingKind.learned_absolute:
            total += self.max_position_embeddings * h
        if self.untie_embeddings_and_output_weights:
            total += v * h
        return total
