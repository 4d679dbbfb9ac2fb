"""Device power/perf table (paper Table 1) + PDP/EDP metrics (§IV.A),
copied from ``repro.analysis.power`` (framework-free).

PDP = Latency x Power  (energy, J)       — eq. (1)
EDP = Latency^2 x Power (J*s)            — eq. (2)

Per the paper's stated methodology, commercial platforms are modeled at
nominal TDP; IMAX uses the phase-aware power model (synthesis power x
active lanes during EXEC + host idle otherwise) — see core/imax_model.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    tdp_w: float                 # nominal TDP (paper Table 1)
    mem_bw_Bps: float            # HBM/GDDR bandwidth
    flops: float                 # dense fp16/bf16 FLOP/s
    overhead_s_per_token: float  # framework/kernel-launch overhead
    session_s: float             # llama.cpp per-request session overhead
    process_nm: int = 0
    chip_area_mm2: float = 0.0


# Public bandwidth/FLOPs specs; the two overhead terms are calibrated to
# the paper's quoted latencies (RTX 4090 ~0.8 s on the representative
# workload; Jetson 1.9 s on Qwen3-1.7B Q8_0 [32:16]).
DEVICE_POWER: Dict[str, DeviceSpec] = {
    "rtx4090": DeviceSpec("NVIDIA RTX 4090", 450.0, 1008e9, 82.6e12,
                          2.0e-3, 0.55, 5, 608),
    "gtx1080ti": DeviceSpec("NVIDIA GTX 1080 Ti", 250.0, 484e9, 11.3e12,
                            4.0e-3, 0.65, 16, 448),
    "jetson_agx_orin": DeviceSpec("Jetson AGX Orin 32GB", 60.0, 204.8e9,
                                  10.6e12, 8.0e-3, 1.5, 8, 200),
}


def pdp(latency_s: float, power_w: float) -> float:
    return latency_s * power_w


def edp(latency_s: float, power_w: float) -> float:
    return latency_s * latency_s * power_w


def gpu_latency(dev: DeviceSpec, model_bytes: float, model_flops_prefill: float,
                n_in: int, n_out: int, offchip_fraction: float = 1.0) -> float:
    """llama.cpp-on-GPU latency model: prefill is compute-bound (one pass
    over the prompt), decode is memory-bound (the quantized weights are
    re-read per generated token), plus per-token framework overhead."""
    t_prefill = model_flops_prefill / dev.flops + dev.overhead_s_per_token
    t_decode = n_out * (model_bytes * offchip_fraction / dev.mem_bw_Bps
                        + dev.overhead_s_per_token)
    return dev.session_s + t_prefill + t_decode


def gpu_metrics(dev: DeviceSpec, model_bytes: float, params_active: float,
                n_in: int, n_out: int) -> Dict:
    flops_prefill = 2.0 * params_active * n_in
    lat = gpu_latency(dev, model_bytes, flops_prefill, n_in, n_out)
    return {
        "device": dev.name,
        "latency_s": lat,
        "power_w": dev.tdp_w,
        "pdp_j": pdp(lat, dev.tdp_w),
        "edp_js": edp(lat, dev.tdp_w),
    }
