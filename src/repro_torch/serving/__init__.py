from repro_torch.serving.engine import (CapacityError, GenStats,
                                        HybridServeEngine,
                                        exact_reference_generate)
