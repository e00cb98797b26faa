"""Training and optimizer configuration (the JAX package's
config/training_config.py, same field names and defaults).

Fields that select machinery the port does not have yet raise when they
are set away from their defaults, naming the flag: the rerun state
machine (whose default, "validate_results", is therefore "disabled"
here), heartbeats and their timeouts, the simulated fault, the straggler
detector, the workload inspector and sharded init, and a master-params
dtype other than fp32. The Adam moments may be stored in bf16
(exp_avg_dtype / exp_avg_sq_dtype); dist_opt_comm picks how ZeRO-1's
updated params return over dp (training/distributed_optimizer.py:
"gspmd" and "bulk" an all-gather, "ring" parallel/overlap.py's
ring_all_gather). Checkpoints (durable and non-persistent),
evaluation, exit_interval, the signal handler, batch-size rampup and the
JSONL / TensorBoard metrics sinks are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_FP32 = ("fp32", "float32")
# The optimizer-state dtype names (training/optimizer.py STATE_DTYPES).
_STATE_DTYPES = _FP32 + ("bf16", "bfloat16")
# --dist-opt-comm's choices (the JAX parser's).
DIST_OPT_COMMS = ("gspmd", "ring", "bulk")
# --trace-granularity's choices (the JAX parser's).
_GRANULARITIES = ("full", "schedule", "collective")


@dataclasses.dataclass
class OptimizerConfig:
    optimizer: str = "adam"          # 'adam' | 'sgd'
    lr: float = 3e-4
    min_lr: float = 3e-5
    lr_decay_style: str = "cosine"   # 'cosine' | 'linear' | 'constant'
    lr_warmup_iters: int = 0
    lr_decay_iters: Optional[int] = None  # default: train_iters
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    clip_grad: float = 1.0
    grad_reduce_in_fp32: bool = True
    main_params_dtype: str = "fp32"
    exp_avg_dtype: str = "fp32"
    exp_avg_sq_dtype: str = "fp32"
    dist_opt_comm: str = "gspmd"

    def __post_init__(self):
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {self.optimizer}")
        if self.lr_decay_style not in ("cosine", "linear", "constant"):
            raise ValueError(f"lr_decay_style {self.lr_decay_style!r}")
        for flag, val in (("--main-params-dtype", self.main_params_dtype),
                          ("--exp-avg-dtype", self.exp_avg_dtype),
                          ("--exp-avg-sq-dtype", self.exp_avg_sq_dtype)):
            if str(val).lower() not in _STATE_DTYPES:
                raise ValueError(f"{flag} expects one of "
                                 f"{sorted(set(_STATE_DTYPES))}, got "
                                 f"{val!r}")
        if str(self.main_params_dtype).lower() not in _FP32:
            raise ValueError(f"--main-params-dtype {self.main_params_dtype}"
                             ": only fp32 params are ported (bf16 params "
                             "with an fp32 master copy: ROADMAP.md Queue 1 "
                             "item 3)")
        if self.dist_opt_comm not in DIST_OPT_COMMS:
            raise ValueError(f"--dist-opt-comm {self.dist_opt_comm!r}: "
                             f"takes {DIST_OPT_COMMS}")
        if not self.grad_reduce_in_fp32:
            raise ValueError("--no-accumulate-allreduce-grads-in-fp32: "
                             "gradients accumulate in fp32 only")


# TrainingConfig fields of machinery the port lacks → the flag that sets
# them. A field set away from its default raises, naming the flag.
UNPORTED_TRAINING_FIELDS = {
    "sharded_init": "--sharded-init",
    "rerun_mode": "--rerun-mode (the rerun state machine)",
    "error_injection_rate": "--error-injection-rate (the rerun state "
                            "machine)",
    "heartbeat_dir": "--heartbeat-dir (fault tolerance)",
    "ft_timeouts": "--ft-timeouts (fault tolerance)",
    "simulated_fault": "--simulated-fault (fault tolerance)",
    "log_straggler": "--log-straggler",
    "run_workload_inspector_server": "--run-workload-inspector-server",
}


@dataclasses.dataclass
class TrainingConfig:
    micro_batch_size: int = 1
    global_batch_size: int = 8
    seq_length: int = 512
    train_iters: int = 100
    seed: int = 1234
    log_interval: int = 10
    eval_interval: Optional[int] = None
    eval_iters: int = 10
    save_interval: Optional[int] = None
    save_dir: Optional[str] = None
    load_dir: Optional[str] = None
    exit_interval: Optional[int] = None
    rampup_batch_size: Optional[tuple] = None
    sharded_init: bool = False
    # NaN guard: a step whose loss or grad norm is not finite keeps the
    # params and optimizer state (the in-step skip is ported).
    check_for_nan_in_loss: bool = True
    loss_spike_factor: float = 10.0
    rerun_mode: str = "disabled"
    error_injection_rate: float = 0.0
    exit_signal_handler: bool = False
    exit_signal_handler_sigint: bool = False
    heartbeat_dir: Optional[str] = None
    ft_timeouts: Optional[tuple] = None
    simulated_fault: Optional[tuple] = None
    non_persistent_save_interval: Optional[int] = None
    non_persistent_ckpt_dir: Optional[str] = None
    log_straggler: bool = False
    run_workload_inspector_server: bool = False
    workload_inspector_port: int = 0
    metrics_jsonl: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    trace: bool = False
    trace_interval: int = 5
    continuous_trace_iterations: int = 2
    trace_dir: str = "trace"
    trace_granularity: str = "full"

    def __post_init__(self):
        if self.trace_granularity not in _GRANULARITIES:
            raise ValueError(f"trace_granularity {self.trace_granularity!r}"
                             f": takes {_GRANULARITIES}")
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, flag in UNPORTED_TRAINING_FIELDS.items():
            if getattr(self, name) != defaults[name]:
                raise ValueError(f"{flag} is not ported to "
                                 "megatronapp_tpu_torch yet (see ROADMAP.md)")

    def resolved_non_persistent_dir(self) -> Optional[str]:
        """Where the local checkpoints live: the explicit dir, else
        <save_dir>/non_persistent when local saves are enabled, else
        None (the JAX TrainingConfig's policy)."""
        if self.non_persistent_ckpt_dir:
            return self.non_persistent_ckpt_dir
        if self.non_persistent_save_interval and self.save_dir:
            import os
            return os.path.join(self.save_dir, "non_persistent")
        return None

    def num_microbatches(self, data_parallel: int) -> int:
        denom = self.micro_batch_size * data_parallel
        if self.global_batch_size % denom != 0:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} not divisible by "
                f"micro_batch_size*dp={denom}")
        return self.global_batch_size // denom
