"""The reference runs on one device: no model of it is built on a process
group, so nothing here is reached."""


def all_reduce_sum(*args, **kwargs):
    raise NotImplementedError("the reference has no process group")


def all_reduce_coalesced(*args, **kwargs):
    raise NotImplementedError("the reference has no process group")
