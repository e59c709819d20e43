"""Host-side hybrid KV/ACT cache machinery (paper §4), copied from
``repro.core`` so the port shares the reference's policy decisions."""
from repro_torch.core.blocks import (BLOCK_TOKENS, BlockManager, BlockType,
                                     Location, act_block_bytes, kv_block_bytes)
from repro_torch.core.controller import ControllerConfig, HybridCacheController
from repro_torch.core.costmodel import (H100_SXM, TPU_V5E, HardwareSpec,
                                        LaneSample, LinearFit,
                                        cpu_attend_seconds_per_token, damp_fit,
                                        ewma_refit, fit_linear, fit_samples,
                                        make_cost_fns, profile_cost_fns)
from repro_torch.core.minibatch import RequestBlocks, form_minibatches
from repro_torch.core.pipeline import (GenerationResult, MiniBatchSpec,
                                       StepConfig, simulate_generation,
                                       simulate_step, simulate_steps)
from repro_torch.core.policy import (HostAllocation, device_act_blocks,
                                     host_block_allocation,
                                     host_block_allocation_threeway,
                                     policy_act_ratio, request_block_split,
                                     store_act_schedule)
