"""Row-wise bitonic sort kernel (counterpart of ``bitonic_pallas``)."""
