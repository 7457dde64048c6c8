"""The port's learners; the counterpart of `pobrax_tpu/training/`.

`ppo` (feed-forward PPO) and `ppo_rnn` (GRU-PPO) with their pieces:
`distribution`, `running_statistics`, `optimizer` (optax's flattened
clip-by-global-norm + Adam, written out) and `checkpoint`. The off-policy
learners (`replay`, `sac`, `sac_rnn`) are still to port (ROADMAP.md).
"""
