"""Step/seconds trigger timer (the SessionRunHook SecondOrStepTimer idiom)."""

import time


class SecondOrStepTimer:
    """Triggers at most every N seconds or every N steps; never without
    either. The first step triggers when a step count is set."""

    def __init__(self, every_secs=None, every_steps=None):
        self._every_secs = every_secs
        self._every_steps = every_steps
        self._last_time = time.time()
        self._last_step = None

    def should_trigger(self, step):
        if self._every_steps is not None:
            if self._last_step is None or step - self._last_step >= \
                    self._every_steps:
                return True
        if self._every_secs is not None:
            if time.time() - self._last_time >= self._every_secs:
                return True
        return False

    def update(self, step):
        self._last_time = time.time()
        self._last_step = step
