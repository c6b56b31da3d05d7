"""How often the card's decode engages: the payload bytes the card
decoded (``card_decoded_bytes``) over those of every member, the card's
and the host's (``xz_decoded_bytes``), %."""

from wtbench.spans import total


def read(run):
    card, host = total(run, "card_decoded_bytes"), total(run,
                                                          "xz_decoded_bytes")
    if card is None or host is None or card + host <= 0:
        return None
    return 100.0 * card / (card + host)
