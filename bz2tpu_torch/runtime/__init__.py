"""Stream orchestration: host split, batched device encode, stitch."""
