from repro_torch.data.pipeline import (DataConfig, Request, lm_batches,
                                       open_loop_trace, request_trace,
                                       token_stream)

__all__ = ["DataConfig", "Request", "lm_batches", "open_loop_trace",
           "request_trace", "token_stream"]
