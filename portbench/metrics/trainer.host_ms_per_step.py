"""trainer.host_ms_per_step.<entry>: the host's wall milliseconds inside
the trainer's own `train_group` and `train_step` ranges
(`train.loop.train_epoch`), per training step of the traced slice."""


def read(record):
    host = record["trace"]["host"]
    ms = 1e3 * (host.get("train_group", 0.0) + host.get("train_step", 0.0))
    if ms <= 0:
        return None
    return ms / record["slice"]["steps"]
