"""Host ms a batch inside ``finalize`` (the ``bench.finalize`` range)
outside its waits for the device (the synchronize calls in it): the host
note decode, re-decodes after a capacity overflow included."""


def read(record):
    if record.trace is None or not record.trace.items:
        return None
    total = 0.0
    found = False
    for node in record.trace.nodes():
        if node.name != 'bench.finalize':
            continue
        found = True
        waits = [n for n in _descendants(node) if 'Synchronize' in n.name]
        total += (node.end - node.start) - sum(n.end - n.start for n in waits)
    if not found:
        return None

    return total * 1e-3 / record.trace.items


def _descendants(node):
    stack = list(node.children)
    while stack:
        child = stack.pop()
        yield child
        stack.extend(child.children)
