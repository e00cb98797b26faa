"""Training and optimizer configuration (the JAX package's
config/training_config.py, same field names and defaults).

Fields that select machinery the port does not have yet raise when they
are set away from their defaults, naming the flag: checkpoints, fault
tolerance, evaluation, batch-size rampup, metrics sinks and the rerun
state machine (whose default, "validate_results", is therefore
"disabled" here), and optimizer state dtypes other than fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_FP32 = ("fp32", "float32")
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
            if str(val).lower() not in _FP32:
                raise ValueError(f"{flag} {val}: only fp32 optimizer state "
                                 "is ported (the ZeRO-1 low-precision "
                                 "moments come with the parallel-training "
                                 "slice)")
        if self.dist_opt_comm != "gspmd":
            raise ValueError(f"--dist-opt-comm {self.dist_opt_comm}: the "
                             "manual ZeRO-1 update is not ported (the "
                             "parallel-training slice)")
        if not self.grad_reduce_in_fp32:
            raise ValueError("--no-accumulate-allreduce-grads-in-fp32: "
                             "gradients accumulate in fp32 only")


# TrainingConfig fields of machinery the port lacks → the flag that sets
# them. A field set away from its default raises, naming the flag.
UNPORTED_TRAINING_FIELDS = {
    "eval_interval": "--eval-interval (evaluation)",
    "save_interval": "--save-interval (checkpoints)",
    "save_dir": "--save (checkpoints)",
    "load_dir": "--load (checkpoints)",
    "exit_interval": "--exit-interval",
    "rampup_batch_size": "--rampup-batch-size (batch-size rampup)",
    "sharded_init": "--sharded-init",
    "rerun_mode": "--rerun-mode (the rerun state machine)",
    "error_injection_rate": "--error-injection-rate (the rerun state "
                            "machine)",
    "exit_signal_handler": "--exit-signal-handler (fault tolerance)",
    "exit_signal_handler_sigint": "--exit-signal-handler (fault "
                                  "tolerance)",
    "heartbeat_dir": "--heartbeat-dir (fault tolerance)",
    "ft_timeouts": "--ft-timeouts (fault tolerance)",
    "simulated_fault": "--simulated-fault (fault tolerance)",
    "non_persistent_save_interval": "--non-persistent-save-interval "
                                    "(checkpoints)",
    "non_persistent_ckpt_dir": "--non-persistent-ckpt-dir (checkpoints)",
    "log_straggler": "--log-straggler",
    "run_workload_inspector_server": "--run-workload-inspector-server",
    "metrics_jsonl": "--metrics-jsonl (metrics sinks)",
    "tensorboard_dir": "--tensorboard-dir (metrics sinks)",
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

    def num_microbatches(self, data_parallel: int) -> int:
        denom = self.micro_batch_size * data_parallel
        if self.global_batch_size % denom != 0:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} not divisible by "
                f"micro_batch_size*dp={denom}")
        return self.global_batch_size // denom
