"""Host-offload runtime: weight streaming overlapped with KV regeneration
(counterpart of ``repro.offload``), for one device or, under a
``ShardPlan``, one weight lane per mesh position.

Pinned host pools, a double-buffered weight streamer on a CUDA copy stream,
a cpu attention lane that attends over spilled KV blocks in place, a
layer-granular executor that is token-exact against the device-resident
decode loop, and measured lane timelines in the analytic simulator's schema.
"""
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.offload.faults import (FAULT_KINDS, FaultEvent, FaultPlan,
                                        TransientCopyError)
from repro_torch.offload.host_attn import (HostAttnExecutor,
                                           host_flash_attention,
                                           merge_partials_torch)
from repro_torch.offload.host_pool import (HostBlockPool, HostWeightPool,
                                           LaneView, Region, ShardedRegion,
                                           ShardedSpillPool, kv_region_blocks,
                                           make_spill_pool)
from repro_torch.offload.streamer import ShardedWeightLanes, WeightStreamer
from repro_torch.offload.timeline import MeasuredTimeline, Span
