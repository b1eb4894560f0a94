"""Three-term roofline of a run on an NVIDIA card (the port's counterpart
of ``repro.roofline.report``).

    compute term    = flops per device / the card's peak (bf16 dense tensor
                      cores for the LM stack; float32 CUDA cores for the
                      clustering kernels)
    memory term     = bytes per device / the card's memory rate
    collective term = link bytes on the card's interconnect / its rate per
                      direction + bytes across the network between nodes /
                      that network's rate

The flops, bytes and link bytes come from an :class:`~repro_torch.roofline.
trace.Analysis` (the work ledger and a mesh's collective records) where the
reference parses HLO; ``model_flops`` and ``analytic_hbm_bytes`` are the
reference's analytic terms for the LM configurations. A card's figures are
its data sheet's (:class:`Hardware`): :data:`H100_SXM` is NVIDIA's H100 SXM
at its full 700 W; :func:`detect` reads the card a run has and refuses one
it has no figures for. The data sheet gives no rate for the network between
nodes, so a report takes it as an argument and assumes none.
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import TYPE_CHECKING, Dict, Optional

import torch

from repro_torch.models.config import ModelConfig

if TYPE_CHECKING:
    from repro_torch.roofline.trace import Analysis


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A card's data-sheet figures (rates per second, memory in bytes) and
    the power limit they assume (W)."""

    name: str
    power_limit_w: float
    fp32_flops: float          # float32 on the CUDA cores
    bf16_flops: float          # bf16 on the tensor cores, dense
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float  # per direction
    memory_bytes: float

    def peak(self, precision: str) -> float:
        """The compute peak for ``precision``: ``"bf16"`` or ``"fp32"``."""
        if precision == "bf16":
            return self.bf16_flops
        if precision == "fp32":
            return self.fp32_flops
        raise ValueError(f"unknown precision {precision!r}; known: bf16, "
                         f"fp32")


# NVIDIA H100 SXM (data sheet, dense rates, at its full 700 W): 67 TFLOP/s
# float32 on the CUDA cores, 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
# of HBM3, NVLink 900 GB/s (450 GB/s each way), 80 GB
H100_SXM = Hardware("NVIDIA H100 SXM", 700.0, 67e12, 989e12, 3.35e12, 450e9,
                    80e9)

# the names nvidia-smi reports for the cards with figures here
KNOWN = {"NVIDIA H100 80GB HBM3": H100_SXM}


def figures(name: str, power_limit_w: float) -> Hardware:
    """The figures of the card ``name`` reports, with its power limit; a
    card below its data sheet's limit runs slower under load than they
    say. Raises for a card with no figures here."""
    hw = KNOWN.get(name.strip())
    if hw is None:
        raise ValueError(f"no figures for the card {name!r}; known: "
                         f"{sorted(KNOWN)}")
    return dataclasses.replace(hw, power_limit_w=float(power_limit_w))


def card(device=0) -> tuple:
    """``(name, power limit W)`` of a CUDA card, as ``nvidia-smi`` reports
    them."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the roofline's figures are a "
                           "card's")
    dev = (torch.device("cuda", device) if isinstance(device, int)
           else torch.device(device))
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits", f"--id={index}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = out.splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit)


def detect(device=0) -> Hardware:
    """The figures of the card at ``device`` with its power limit; raises
    on a card with no figures here rather than assume an H100."""
    return figures(*card(device))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # measured, per device
    hlo_dot_flops: float
    hlo_elementwise_flops: float
    hlo_result_bytes: float
    ici_bytes: float
    dcn_bytes: float
    collective_counts: Dict[str, float]
    collective_bytes_by_kind: Dict[str, float]
    # another tool's own count of the same program, where there is one
    xla_flops: float
    xla_bytes: float
    peak_memory_bytes: float
    # analytic
    model_flops_total: float
    analytic_hbm_bytes: float
    # terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flop_ratio: float = 0.0
    roofline_fraction: float = 0.0

    def finalize(self, hardware: Hardware,
                 network_bytes_per_s: Optional[float] = None,
                 precision: str = "bf16") -> "RooflineReport":
        """The three terms on ``hardware`` at ``precision``'s peak.
        Bytes across the network between nodes need its rate
        (``network_bytes_per_s``): no figure is assumed."""
        peak = hardware.peak(precision)
        self.compute_s = self.hlo_dot_flops / peak
        mem_bytes = min(self.hlo_result_bytes, self.analytic_hbm_bytes) \
            if self.analytic_hbm_bytes > 0 else self.hlo_result_bytes
        self.memory_s = mem_bytes / hardware.hbm_bytes_per_s
        if self.dcn_bytes > 0 and network_bytes_per_s is None:
            raise ValueError(f"{self.dcn_bytes} bytes cross the network "
                             f"between nodes, and no rate was given for it")
        self.collective_s = self.ici_bytes / hardware.nvlink_bytes_per_s + (
            self.dcn_bytes / network_bytes_per_s if self.dcn_bytes else 0.0)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        per_dev_model = self.model_flops_total / max(self.n_devices, 1)
        self.useful_flop_ratio = (per_dev_model
                                  / max(self.hlo_dot_flops, 1.0))
        # fraction of the compute roofline the dominant-term-limited step
        # achieves: useful flops / (peak * step_time_lower_bound)
        step_t = max(terms.values())
        self.roofline_fraction = (per_dev_model / peak) / max(step_t, 1e-30)
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.compute_s:.4e},{self.memory_s:.4e},"
                f"{self.collective_s:.4e},{self.bottleneck},"
                f"{self.useful_flop_ratio:.3f},{self.roofline_fraction:.3f}")


def model_flops(cfg: ModelConfig, kind: str, seq_len: int,
                global_batch: int) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


def analytic_hbm_bytes(cfg: ModelConfig, kind: str, seq_len: int,
                       global_batch: int, n_devices: int,
                       microbatches: int = 1) -> float:
    """Per-device memory traffic floor: parameters read (+ optimizer state
    read/write for training) once per step plus KV/state cache traffic for
    decode. Activations are assumed resident in on-chip memory at the
    floor."""
    n = cfg.param_count()
    if kind == "train":
        # fwd reads params (bf16 cast) per microbatch; grads + adam m,v f32
        param_traffic = (2.0 * n * microbatches      # fwd+bwd reads, bf16
                         + 4.0 * n * 4               # grad w + m/v rw f32
                         )
        return param_traffic / n_devices
    if kind == "prefill":
        return 2.0 * n / n_devices
    # decode: params once + full KV/state cache read per token
    cache = 0.0
    kinds = (list(cfg.pattern) * cfg.n_full_periods
             + list(cfg.remainder_kinds))
    for k in kinds:
        if k == "attn":
            cache += (2 * global_batch * seq_len * cfg.n_kv_heads
                      * cfg.head_dim * 2)
        elif k == "local":
            cache += (2 * global_batch * min(cfg.window, seq_len)
                      * cfg.n_kv_heads * cfg.head_dim * 2)
        elif k == "ssd":
            cache += (global_batch * cfg.ssm_nheads * cfg.ssm_headdim
                      * cfg.ssm_state * 4)
        elif k == "rglru":
            cache += global_batch * cfg.lru_width * 4
    return (2.0 * cfg.active_param_count() + cache) / n_devices


def build_report(arch: str, shape_name: str, mesh_name: str,
                 cfg: Optional[ModelConfig], kind: str, seq_len: int,
                 global_batch: int, n_devices: int, analysis: "Analysis",
                 measured_cost: Optional[Dict], peak_memory: float,
                 hardware: Hardware, microbatches: int = 1,
                 network_bytes_per_s: Optional[float] = None,
                 precision: str = "bf16") -> RooflineReport:
    """The report of one run from its :class:`Analysis`. ``cfg`` None (a
    clustering route, no LM) leaves the analytic terms at 0, so the memory
    term takes the analysis' bytes; ``measured_cost`` is another tool's
    ``{"flops", "bytes accessed"}`` of the same run, where there is
    one."""
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_devices,
        hlo_dot_flops=analysis.dot_flops,
        hlo_elementwise_flops=analysis.elementwise_flops,
        hlo_result_bytes=analysis.result_bytes,
        ici_bytes=analysis.ici_collective_bytes,
        dcn_bytes=analysis.dcn_collective_bytes,
        collective_counts=analysis.collective_counts,
        collective_bytes_by_kind=analysis.collective_bytes_by_kind,
        xla_flops=float((measured_cost or {}).get("flops", 0.0)),
        xla_bytes=float((measured_cost or {}).get("bytes accessed", 0.0)),
        peak_memory_bytes=peak_memory,
        model_flops_total=(0.0 if cfg is None else
                           model_flops(cfg, kind, seq_len, global_batch)),
        analytic_hbm_bytes=(0.0 if cfg is None else analytic_hbm_bytes(
            cfg, kind, seq_len, global_batch, n_devices, microbatches)),
    )
    return rep.finalize(hardware, network_bytes_per_s, precision)
