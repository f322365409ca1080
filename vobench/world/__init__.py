"""The benchmark's synthetic world: renderer, trajectories, BA windows."""
