"""What the readers of the program's spans share: the host's wall
seconds inside spans of given names in the traced slice (`trace.host`,
from `torch.profiler`), in milliseconds per unit or per step."""


def ms_per(record, span: str, per: str):
    """1e3 x the wall seconds of `span` over `record["slice"][per]`
    ("units" or "steps"); None where the slice has no such span."""
    host = record["trace"]["host"]
    if span not in host:
        return None
    return 1e3 * host[span] / record["slice"][per]
