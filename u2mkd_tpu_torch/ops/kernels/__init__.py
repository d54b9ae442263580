import contextlib


@contextlib.contextmanager
def wrappers_replaced(stand_ins):
    """Inside, each ``{(module, name): fn}`` of ``stand_ins`` takes the
    place of the counted kernel wrapper ``module.name`` (``fn`` may call the
    wrapper it replaces). A wrapper counts its launches on the function its
    module's name holds, which is then ``fn``: the count is carried to ``fn``
    and back to the wrapper afterwards."""
    saved = []
    try:
        for (mod, name), fn in stand_ins.items():
            wrapper = getattr(mod, name)
            fn.launches = wrapper.launches
            saved.append((mod, name, wrapper))
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, wrapper in reversed(saved):
            wrapper.launches = getattr(mod, name).launches
            setattr(mod, name, wrapper)
