from .streamed_two_phase import (LAUNCHES, make_streamed_T_log, pass_b,
                                 pass_b_plain, pass_c, pass_c_plain,
                                 pass_b_deferred, pass_b_deferred_plain,
                                 pass_c_deferred, pass_c_deferred_plain,
                                 streamed_config, streamed_supported)
from .tiled_two_phase import (make_tiled_T_log, make_tiled_T_log_ssy,
                              make_tiled_T_log_gcy)

__all__ = ["LAUNCHES", "make_streamed_T_log", "pass_b", "pass_b_plain",
           "pass_c", "pass_c_plain", "pass_b_deferred",
           "pass_b_deferred_plain", "pass_c_deferred",
           "pass_c_deferred_plain", "streamed_config", "streamed_supported",
           "make_tiled_T_log", "make_tiled_T_log_ssy",
           "make_tiled_T_log_gcy"]
