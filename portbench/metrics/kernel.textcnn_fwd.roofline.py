"""kernel.textcnn_fwd.roofline.<entry>: the TextCNN forward's share of
its roofline in the traced slice, in percent: the least time the card
could take for the forward work the slice's units required (summed
max(FLOP / peak, bytes / bandwidth) a tower launch,
`portbench.counts.textcnn_fwd_bound_s`) over the device time of every
kernel named `textcnn_pool_fwd*`. Nothing when no such kernel ran."""


def read(record):
    ms = sum(v for k, v in record["trace"]["kernels"].items()
             if "textcnn_pool_fwd" in k)
    if ms <= 0:
        return None
    return 100.0 * record["slice"]["fwd_bound_s"] / ms
