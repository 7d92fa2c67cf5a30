"""Host-side helpers: the replay buffer and the evaluation metrics."""
