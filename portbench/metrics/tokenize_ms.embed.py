"""Host milliseconds a call spends tokenizing and padding its texts: the
mean of the program's ``embed.tokenize`` spans in the traced window."""

from portbench import spans


def read(run):
    return spans.mean_ms(run, "embed.tokenize")
