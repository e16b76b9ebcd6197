"""Auxiliary subsystems of the port: I/O, config, profiling."""

from .config import SchemeConfig, load_config
from .io import (
    load_checkpoint,
    save_checkpoint,
    save_levelset,
    save_tags,
    write_vti,
    write_vtu,
    write_vtu_umesh,
    write_xdmf,
)
from .profiling import Timer, device_trace, report_throughput

__all__ = [
    "save_levelset",
    "save_tags",
    "write_vtu",
    "write_vtu_umesh",
    "write_vti",
    "write_xdmf",
    "save_checkpoint",
    "load_checkpoint",
    "SchemeConfig",
    "load_config",
    "Timer",
    "report_throughput",
    "device_trace",
]
