"""The card's decode rate a stream: the payload bytes its members gave
(``card_decoded_bytes``) over the sum of each member's own kernel time
(``card_decode_seconds``, from its block's start and end), MB/s."""

from wtbench.spans import ratio


def read(run):
    return ratio(run, "card_decoded_bytes", "card_decode_seconds", 1e-6)
