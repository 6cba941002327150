"""The work of one unit of an algorithm, whatever implements it: float32
operations and the bytes each input read once and each output written once
take, against the published peaks of ``peaks.json``."""
