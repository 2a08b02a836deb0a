"""Real-world backend modules: one `env_<name>.py` per deployment, each
providing RealWorldCar + RealWorldCamera subclasses (see env_loopback for
a runnable headless example)."""
