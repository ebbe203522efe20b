"""Host helpers: numpy math shared by the data plane, stage timing."""
