"""Communication logging (port of ``deepspeed_tpu/comm/comms_logging.py``).

Records per-op name, size and latency and computes algorithmic and bus
bandwidth with the reference's formulas (``calc_bw_log``). The latency is
the host's wall clock around the collective with the device synchronised
before and after, so it is taken only while logging is enabled.
"""

import logging
import math
from typing import List

logger = logging.getLogger(__name__)


def calc_bw_log(comm_op, size, duration, n):
    """Return (algbw, busbw) in GB/s for a collective of `size` bytes over
    `n` participants; factors follow the reference's nccl-tests convention."""
    duration = max(duration, 1e-9)
    if comm_op in ("all_to_all_single", "all_to_all"):
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / max(n, 1))
    elif comm_op in ("all_gather", "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor"):
        size *= n
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / max(n, 1))
    elif comm_op == "all_reduce":
        tput = size * 2 / duration
        busbw = (size / duration) * (2 * (n - 1) / max(n, 1))
    else:  # broadcast / send / recv / barrier / pt2pt
        tput = size / duration
        busbw = tput
    tput /= 1e9
    busbw /= 1e9
    return tput, busbw


def trim_mean(data, trim_percent):
    """The mean of ``data`` without its ``trim_percent`` tails."""
    assert 0.0 <= trim_percent <= 1.0
    n = len(data)
    data.sort()
    k = int(round(n * trim_percent))
    if len(data[k:n - k]) == 0:
        return sum(data) / n
    return sum(data[k:n - k]) / max(len(data[k:n - k]), 1)


class CommsLoggerConfig:
    """The ``comms_logger`` config section with its defaults."""

    _DEFAULTS = {"enabled": False, "prof_all": True, "prof_ops": [], "verbose": False,
                 "debug": False}

    def __init__(self, section=None):
        section = section or {}
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))


class CommsLogger:

    def __init__(self, config=None):
        config = config or CommsLoggerConfig()
        self.comms_dict = {}
        self.verbose = config.verbose
        self.debug = config.debug
        self.prof_ops = list(config.prof_ops)
        self.prof_all = config.prof_all
        self.enabled = config.enabled

    def configure(self, config):
        self.enabled = config.comms_config.enabled
        self.verbose = config.comms_config.verbose
        self.debug = config.comms_config.debug
        self.prof_ops = list(config.comms_config.prof_ops)
        self.prof_all = config.comms_config.prof_all

    def start_profiling_comms(self):
        self.prof_all = True

    def stop_profiling_comms(self):
        self.prof_all = False

    def start_profiling_op(self, op_name_list: List[str]):
        self.prof_ops = list(set(self.prof_ops) | set(op_name_list))

    def stop_profiling_op(self, op_name_list: List[str]):
        self.prof_ops = [op for op in self.prof_ops if op not in op_name_list]

    def records(self, name: str) -> bool:
        """Whether op ``name`` is timed now."""
        return self.enabled and (self.prof_all or name in self.prof_ops)

    def append(self, raw_name, record_name, latency, msg_size, n_participants=1):
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency, n_participants)
        entry = self.comms_dict.setdefault(record_name, {})
        if msg_size in entry:
            entry[msg_size][0] += 1
            entry[msg_size][1].append(latency)
            entry[msg_size][2].append(algbw)
            entry[msg_size][3].append(busbw)
        else:
            entry[msg_size] = [1, [latency], [algbw], [busbw]]
        if self.verbose:
            logger.info(f"comm op: {record_name} | time (ms): {latency * 1000:.2f} | msg size: "
                        f"{convert_size(msg_size)} | algbw (Gbps): {algbw * 8:.2f} | "
                        f"busbw (Gbps): {busbw * 8:.2f}")

    def log_all(self, print_log=True, show_straggler=False):
        if print_log:
            print(f"{'Comm. Op': <20}{'Message Size': <20}{'Count': <20}"
                  f"{'Total Latency(ms)': <20}{'Avg Latency(ms)': <20}"
                  f"{'tput_avg (Gbps)': <20}{'busbw_avg (Gbps)': <20}")
        for record_name in self.comms_dict.keys():
            if print_log:
                print(record_name)
            for msg_size, vals in sorted(self.comms_dict[record_name].items()):
                count = vals[0]
                total_lat = sum(vals[1])
                avg_lat = trim_mean(vals[1], 0.1)
                avg_algbw = trim_mean(vals[2], 0.1)
                avg_busbw = trim_mean(vals[3], 0.1)
                if print_log:
                    print(f"{' ': <20}{convert_size(msg_size): <20}{count: <20}"
                          f"{total_lat * 1000: <20.2f}{avg_lat * 1000: <20.2f}"
                          f"{avg_algbw * 8: <20.2f}{avg_busbw * 8: <20.2f}")
        return self.comms_dict


def convert_size(size_bytes):
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return "%s %s" % (s, size_name[i])


_COMMS_LOGGER = None


def get_comms_logger() -> CommsLogger:
    global _COMMS_LOGGER
    if _COMMS_LOGGER is None:
        _COMMS_LOGGER = CommsLogger()
    return _COMMS_LOGGER
