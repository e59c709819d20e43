from repro_torch.serving.engine import (GenStats, HybridServeEngine,
                                        exact_reference_generate)
from repro_torch.serving.recovery import (CapacityError, ParkedRequest,
                                          RecoveryConfig, RecoveryStats)
from repro_torch.serving.scheduler import (ContinuousBatchingServer,
                                           ServeStats)
