"""Host modules (numpy) and the executors of the port."""
