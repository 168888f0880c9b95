"""Input state (counterpart of sailor_tpu/engine/input.py,
Platform/Win32/Input.h): a 256-key keyboard, 3 mouse buttons and the
cursor, with the pressed-this-frame edges derived at ``end_frame``.
Frontends inject events; components read ``world.input`` during tick."""

from __future__ import annotations

UP, DOWN = 0, 1

# key codes (VK_* parity for the ones content uses)
KEY_W, KEY_A, KEY_S, KEY_D = 87, 65, 83, 68
KEY_Q, KEY_E, KEY_U = 81, 69, 85
KEY_SPACE, KEY_SHIFT, KEY_F5, KEY_F6 = 32, 16, 116, 117


class InputState:
    """Keyboard, mouse and cursor snapshot with per-frame edge tracking."""

    def __init__(self):
        self._keys = bytearray(256)
        self._mouse = bytearray(3)
        self.cursor = (0, 0)
        self._prev_keys = bytearray(256)
        self._prev_mouse = bytearray(3)
        self._prev_cursor = None

    def key_down(self, code: int) -> None:
        if 0 <= code < 256:
            self._keys[code] = DOWN

    def key_up(self, code: int) -> None:
        if 0 <= code < 256:
            self._keys[code] = UP

    def button_down(self, b: int) -> None:
        if 0 <= b < 3:
            self._mouse[b] = DOWN

    def button_up(self, b: int) -> None:
        if 0 <= b < 3:
            self._mouse[b] = UP

    def move_cursor(self, x: int, y: int) -> None:
        self.cursor = (int(x), int(y))

    def is_key_down(self, code: int) -> bool:
        return self._keys[code] != UP

    def is_key_pressed(self, code: int) -> bool:
        """Down this frame (the edge)."""
        return self._keys[code] != UP and self._prev_keys[code] == UP

    def is_button_down(self, b: int) -> bool:
        return self._mouse[b] != UP

    def is_button_click(self, b: int) -> bool:
        return self._mouse[b] != UP and self._prev_mouse[b] == UP

    def cursor_delta(self) -> tuple[int, int]:
        px, py = self.cursor if self._prev_cursor is None else self._prev_cursor
        return self.cursor[0] - px, self.cursor[1] - py

    def end_frame(self) -> None:
        """Frame boundary (InputState::TrackForChanges)."""
        self._prev_keys = bytearray(self._keys)
        self._prev_mouse = bytearray(self._mouse)
        self._prev_cursor = self.cursor
